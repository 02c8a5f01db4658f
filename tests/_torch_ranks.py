"""Rank bodies for ``tests/test_torch_distributed.py``.

``launch.mesh.run_ranks`` starts each rank in a fresh (spawned) process
that imports its function by module path, so these live apart from the
test file: this module imports neither JAX nor the reference package.
Every function takes the rank's mesh first and returns plain Python and
numpy values, which the test compares with the single-device runs.
"""
import contextlib

import numpy as np
import torch

from repro_torch import _bridge
from repro_torch.analysis import audit_engine_sharding
from repro_torch.checkpoint import CheckpointManager
from repro_torch.api import structured_prune
from repro_torch.configs import MoEConfig, PruneConfig, get_arch, scaled_down
from repro_torch.core.masks import lm_prunable, tree_flatten_with_path
from repro_torch.data.pipeline import ShardedBatcher
from repro_torch.distributed.compression import (compressed_psum,
                                                 dp_allreduce_compressed)
from repro_torch.distributed.fault_tolerance import elastic_restore
from repro_torch.distributed.tensor_parallel import (ShardedModel,
                                                     mesh_rules,
                                                     sharded_loss)
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import transformer as ttfm
from repro_torch.serve.engine import Request, ServeEngine


def tiny_llama():
    return scaled_down(get_arch("llama3.2-3b"), dtype="float32")


def aligned_llama():
    """Every projection tiles at 128 on a (., 2) mesh: 4 heads of 128,
    2 kv heads, d_ff 1024."""
    return scaled_down(get_arch("llama3.2-3b"), dtype="float32", n_layers=2,
                       d_model=512, n_heads=4, n_kv_heads=2, head_dim=128,
                       d_ff=1024)


def tiny_moe():
    return scaled_down(get_arch("llama3.2-3b"), dtype="float32",
                       n_layers=2, moe=MoEConfig(4, 2, 64))


def yi_loss_cfg():
    return scaled_down(get_arch("yi-6b"), dtype="float32", d_model=128,
                       n_heads=4, n_kv_heads=4, head_dim=32)


def serve(cfg, params, masks, prompts, *, mesh=None, paged=True, slots=2,
          capacity=48, max_new=6):
    """(engine, {uid: tokens}, {uid: (steps, V) logits rows})."""
    eng = ServeEngine(params=params, cfg=cfg, batch_slots=slots,
                      capacity=capacity, paged=paged, masks=masks,
                      mesh=mesh, device="cpu")
    rows = {}
    eng.logits_sink = lambda uid, row: rows.setdefault(uid, []).append(
        np.array(row, copy=True))
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=max_new))
    out = {r.uid: list(r.tokens) for r in eng.run()}
    return eng, out, {k: np.stack(v) for k, v in rows.items()}


def _scenarios(mesh, params_np, masks_np, prompts):
    cfg = tiny_llama()
    params = _bridge.params_from_numpy(params_np, device="cpu")
    out = {}
    for paged in (False, True):
        for pruned in (False, True):
            eng, streams, rows = serve(cfg, params,
                                       masks_np if pruned else None,
                                       prompts, mesh=mesh, paged=paged)
            out[(paged, pruned)] = dict(
                streams=streams, rows=rows, whole=eng.kept_whole,
                audit=[(f.code, f.severity)
                       for f in audit_engine_sharding(eng)])
    return out


def _record_kernels(fn):
    """fn() with the 2-D bsmm wrappers and the attention kernels
    recording the shapes they are entered with."""
    from repro_torch.kernels import bsmm
    from repro_torch.models import attention
    seen = []
    saved = {}

    def wrap(mod, name):
        orig = getattr(mod, name)
        saved[(mod, name)] = orig

        def rec(*a, **k):
            seen.append((name, tuple(a[0].shape), tuple(a[1].shape)))
            return orig(*a, **k)
        setattr(mod, name, rec)

    for name in ("bsmm", "bsmm_epilogue"):
        wrap(bsmm, name)
    for name in ("flash_attention", "paged_attention"):
        wrap(attention, name)
    try:
        res = fn()
    finally:
        for (mod, name), orig in saved.items():
            setattr(mod, name, orig)
    return res, seen


def model_axis_rank(mesh, params_np, masks_np, prompts, aligned, ckpt):
    """(1, 2): the tiny scenarios, the tile-aligned variant with the
    kernels' entry shapes, biased projections, K/V kept whole, two
    meshes and a meshless
    engine interleaved in one process, an elastic restore of ``ckpt``
    and a compressed all-reduce over the model axis."""
    res = {"rank": mesh.get_rank(),
           "scenarios": _scenarios(mesh, params_np, masks_np, prompts)}

    acfg = aligned_llama()
    aparams = _bridge.params_from_numpy(aligned["params"], device="cpu")
    (eng, streams, rows), seen = _record_kernels(
        lambda: serve(acfg, aparams, aligned["masks"], prompts, mesh=mesh))
    st = eng.generations[-1].plan_stats
    res["aligned"] = dict(streams=streams, rows=rows, seen=seen,
                          whole=eng.kept_whole, routed=st.routed,
                          dense_fallback=st.dense_fallback)

    # biases on the model axis: qwen2's q/k/v biases and an MLP's,
    # seeded noise (zeros would hide a mis-sliced bias)
    bcfg = scaled_down(get_arch("qwen2-72b"), dtype="float32",
                       mlp_bias=True)
    bparams = ttfm.init_params(torch.Generator().manual_seed(4), bcfg,
                               device="cpu")
    g = torch.Generator().manual_seed(5)
    for _, leaf in tree_flatten_with_path(bparams):
        if leaf is not None and leaf.ndim >= 1 and not leaf.any():
            leaf.copy_(torch.randn(leaf.shape, generator=g) * 0.1)
    res["biases"] = [serve(bcfg, bparams, None, prompts, mesh=m)[1:]
                     for m in (None, mesh)]

    # K/V kept whole: 6 q heads over 3 kv heads, 3 q heads a rank
    # mapping to partial groups (kv 0, 0, 1 and 1, 2, 2)
    kcfg = scaled_down(get_arch("llama3.2-3b"), dtype="float32",
                       d_model=192, n_heads=6, n_kv_heads=3, head_dim=32)
    kparams = ttfm.init_params(torch.Generator().manual_seed(6), kcfg,
                               device="cpu")
    res["kv_whole"] = {}
    for paged in (False, True):
        runs = [serve(kcfg, kparams, None, prompts, mesh=m, paged=paged)
                for m in (None, mesh)]
        eng = runs[1][0]
        res["kv_whole"][paged] = dict(
            runs=[r[1:] for r in runs], whole=eng.kept_whole,
            heads=(eng.generations[-1].cfg.n_heads,
                   eng.generations[-1].cfg.n_kv_heads))

    # two meshes and a meshless engine, stepped in turns
    cfg = tiny_llama()
    params = _bridge.params_from_numpy(params_np, device="cpu")
    mesh21 = make_test_mesh(2, 1, device="cpu")
    engines = [ServeEngine(params=params, cfg=cfg, batch_slots=2,
                           capacity=48, masks=masks_np, mesh=m,
                           device="cpu")
               for m in (mesh, mesh21, None)]
    for eng in engines:
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
    done = [[] for _ in engines]
    while not all(e.idle for e in engines):
        for e, d in zip(engines, done):
            d.extend(e.step())
    res["coexist"] = [{r.uid: list(r.tokens) for r in d} for d in done]

    # elastic restore of a (2, 2) checkpoint onto this (1, 2) mesh
    lcfg = yi_loss_cfg()
    template = {"params": _bridge.params_from_numpy(ckpt["params"],
                                                    device="cpu"),
                "step": np.zeros((), np.int64)}
    rules = mesh_rules(mesh, lcfg)
    step, tree = elastic_restore(ckpt["dir"], template, mesh, cfg=lcfg)
    model = ShardedModel.from_local(tree["params"], template["params"],
                                    lcfg, rules)
    res["restored"] = dict(step=step, loss=sharded_loss(model, ckpt["batch"]),
                           local_wq=tuple(tree["params"]["segments"][0][0]
                                          ["attn"]["wq"].shape))
    # ... and under a pruned ticket whose q shards would cut a 128-tile:
    # placed as ShardedModel.from_full places the full tree
    ymasks = structured_prune(template["params"], [("xbar", 0.5)],
                              prunable=lm_prunable, cfg=PruneConfig())
    _, ptree = elastic_restore(ckpt["dir"], template, mesh, cfg=lcfg,
                               masks=ymasks)
    pmodel = ShardedModel.from_local(ptree["params"], template["params"],
                                     lcfg, rules, ymasks)
    full = ShardedModel.from_full(template["params"], lcfg, rules, ymasks)
    pairs = list(zip(tree_flatten_with_path(pmodel.params),
                     tree_flatten_with_path(full.params)))
    res["restored_pruned"] = dict(
        same=all(pa == pb and torch.equal(a, b)
                 for (pa, a), (pb, b) in pairs),
        leaves=len(pairs), whole=pmodel.whole, full_whole=full.whole,
        heads=(pmodel.cfg.n_heads, full.cfg.n_heads),
        loss=sharded_loss(pmodel, ckpt["batch"]))

    # compressed all-reduce over the model axis's two ranks
    g = torch.from_numpy(ckpt["grads"][mesh.get_rank()])
    res["psum"] = compressed_psum(g, mesh.get_group("model"), 5).numpy()
    return res


def data_axis_rank(mesh, params_np, masks_np, prompts, moe, grads):
    """(2, 1): the tiny scenarios, the MoE engine (grouped dispatch at
    prefill, one group a shard at decode), the batcher's rows and the
    compressed data-parallel all-reduce."""
    res = {"rank": mesh.get_rank(),
           "scenarios": _scenarios(mesh, params_np, masks_np, prompts)}
    mparams = _bridge.params_from_numpy(moe["params"], device="cpu")
    _, streams, _ = serve(tiny_moe(), mparams, None, moe["prompts"],
                          mesh=mesh, paged=False)
    res["moe"] = streams

    batcher = ShardedBatcher(
        lambda step: {"tokens": np.arange(32).reshape(8, 4) + step,
                      "odd": np.arange(3)}, mesh)
    res["batches"] = [next(batcher) for _ in range(2)]

    def grads_fn(x):
        return {"w": x * 1.0, "b": {"v": x[:3] * 2.0}}
    red = dp_allreduce_compressed(grads_fn, mesh, "data", 0.25)
    out = red(torch.from_numpy(grads[mesh.get_rank()]))
    res["dp_grads"] = {"w": out["w"].numpy(), "v": out["b"]["v"].numpy()}
    return res


def loss_rank(mesh, params_np, batch, ckpt_dir):
    """(2, 2): the tensor- and data-parallel loss of a global batch, then
    a checkpoint of the sharded params (gathered, rank 0 writes)."""
    cfg = yi_loss_cfg()
    params = _bridge.params_from_numpy(params_np, device="cpu")
    model = ShardedModel.from_full(params, cfg, mesh_rules(mesh, cfg))
    loss = sharded_loss(model, batch)
    CheckpointManager(ckpt_dir).save(
        7, {"params": model.params, "step": np.array(7)},
        shardings={"params": model.shardings})
    return dict(loss=loss, whole=model.whole,
                local_wo=tuple(model.params["segments"][0][0]["attn"]
                               ["wo"].shape))


# ---------------------------------------------------------------------------
# tests/test_torch_tp_train.py and the J207 test of tests/test_torch_lint.py
# ---------------------------------------------------------------------------
def _gathered(tree, shardings):
    """{path: numpy} of a rank-local tree gathered to full shapes."""
    from repro_torch.distributed.sharding import gather_full
    from repro_torch.distributed.tensor_parallel import _lookup
    return {path: gather_full(leaf.contiguous(), _lookup(shardings, path))
            .numpy() for path, leaf in tree_flatten_with_path(tree)}


def tp_train_rank(mesh, scenarios, batches, lr):
    """Per scenario ``(cfg, params_np, masks_np)``: the gradients of the
    first batch and two AdamW steps of the tensor-parallel train step
    (``masked`` over the local masks, the loss through the local plan
    when masks are given), gathered to full shapes; plus which leaves
    are replicated over ``model`` and their local bits; on a data axis
    the same two steps under ZeRO-1 (``zero1``: losses, parameters and
    how many leaves' moments the rank holds a part of)."""
    from repro_torch.distributed.tensor_parallel import (Zero1,
                                                         data_grad_sum,
                                                         data_rows, localize,
                                                         train_loss,
                                                         train_scope)
    from repro_torch.optim import adamw, constant, masked
    from repro_torch.train.loop import _value_and_grad, make_train_step
    from repro_torch.train.plans import lm_train_plan

    out = []
    for cfg, params_np, masks_np in scenarios:
        params = _bridge.params_from_numpy(params_np, device="cpu")
        masks = None
        if masks_np is not None:
            masks = _bridge.params_from_numpy(masks_np, device="cpu")
            params = _bridge.apply_masks(params, masks)
        rules = mesh_rules(mesh, cfg)
        model = ShardedModel.from_full(params, cfg, rules, masks)
        opt, plan = adamw(constant(lr)), None
        if masks is not None:
            lmasks = localize(masks, model.shardings, contiguous=False)
            plan = lm_train_plan(lmasks)[0]
            opt = masked(opt, lmasks)
        loss, scope = train_loss(model, plan=plan), train_scope(model)
        reduce = data_grad_sum(rules)
        rows = [data_rows(b, rules) for b in batches]
        with scope(model.params):
            l0, _, g = _value_and_grad(loss, model.params, rows[0])
        l0, g = reduce(l0, g)
        step = make_train_step(loss, opt, sharded=model)
        p, st, losses = model.params, opt.init(model.params), []
        for b in rows:
            p, st, m = step(p, st, b)
            losses.append(float(m["loss"]))
        replicated = [path for path, sh in tree_flatten_with_path(
            model.shardings) if "model" not in sh.spec]
        local = dict(tree_flatten_with_path(p))
        zero1 = None
        if rules.axis_sizes["data"] > 1:
            z1 = Zero1(model)
            zopt = adamw(constant(lr))
            if masks is not None:
                zopt = masked(zopt, z1.part(lmasks))
            zstep = make_train_step(loss, zopt, sharded=model, zero1=True)
            zp, zst, zlosses = model.params, zopt.init(z1.part(
                model.params)), []
            for b in rows:
                zp, zst, m = zstep(zp, zst, b)
                zlosses.append(float(m["loss"]))
            parted = sum(a.shape != b.shape for a, b in zip(
                _bridge.tree_leaves(zst["m"]), _bridge.tree_leaves(zp)))
            zero1 = dict(losses=zlosses, params=_gathered(
                zp, model.shardings), parted=parted)
        out.append(dict(
            loss0=float(l0), grads=_gathered(g, model.shardings),
            losses=losses, params=_gathered(p, model.shardings),
            replicated={k: local[k].numpy() for k in replicated},
            zero1=zero1,
            sharded=len(model.tp._sharded) if model.tp else 0))
    return out


def launcher_rank(mesh, arch, cfg, extra=()):
    """``launch.train.main`` (and ``extra`` flags) on this rank's process
    group, the production mesh's shape swapped for ``mesh``'s and the
    arch's config for ``cfg``: its multi-rank branch.  Returns the step,
    the final norm's bits, the table's shape and the shape of the first
    moment of ``embed/table``."""
    import repro_torch.configs as configs
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train as ltrain

    axes = lmesh.mesh_axes(mesh)
    lmesh.production_shape = lambda multi_pod=False: axes
    configs.get_arch = lambda name: cfg
    trainer = ltrain.main(["--arch", arch, "--steps", "2", "--batch", "2",
                           "--seq", "16", "--device", "cpu", *extra])
    flat = dict(tree_flatten_with_path(trainer.state.params))
    moment = dict(tree_flatten_with_path(trainer.state.opt_state["m"]))
    return dict(step=trainer.state.step,
                norm=flat["final_norm/scale"].numpy(),
                table_shape=tuple(flat["embed/table"].shape),
                moment_shape=tuple(moment["embed/table"].shape))


def hlo_rank(mesh):
    """J206/J207 of a mesh engine's traced prefill (``audit_traced``
    under the generation's scope) and of the meshless engine's."""
    from repro_torch.analysis import audit_traced

    cfg = aligned_llama()
    params = ttfm.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    toks = torch.ones((1, 8), dtype=torch.long)
    got = {}
    for label, m in (("mesh", mesh), ("meshless", None)):
        eng = ServeEngine(params=params, cfg=cfg, mesh=m, batch_slots=2,
                          capacity=64, device="cpu")
        gen = eng.generations[-1]
        sm = getattr(gen, "sharded", None)
        p, c = (sm.params, sm.cfg) if sm is not None else (params, cfg)

        def prefill(p, cap):
            with torch.inference_mode():
                return ttfm.prefill(p, c, {"tokens": toks}, cap)

        scope = sm.scope() if sm is not None else contextlib.nullcontext()
        with scope:
            fs = audit_traced(prefill, [p, 64], where=f"{label}/prefill.hlo")
        got[label] = [(f.code, f.severity, f.where, f.msg) for f in fs]
    return got


# ---------------------------------------------------------------------------
# tests/test_torch_mesh_families.py
# ---------------------------------------------------------------------------
def _module(cfg):
    from repro_torch.models import encdec
    return encdec if cfg.is_encoder_decoder else ttfm


def family_serve(mesh, cfg, params_np, requests, slots=2, capacity=48):
    """The mesh engine of ``cfg`` over ``requests`` [(uid, prompt,
    max_new, frames)]: its streams, every logits row in the order the
    engine samples them (uid, row), the kept-whole list, the local
    config's heads and the J208 audit."""
    from repro_torch.models import encdec
    params = _bridge.params_from_numpy(params_np, device="cpu")
    kw = (dict(prefill_fn=encdec.prefill, decode_fn=encdec.decode_step)
          if cfg.is_encoder_decoder else {})
    eng = ServeEngine(params=params, cfg=cfg, batch_slots=slots,
                      capacity=capacity, mesh=mesh, device="cpu", **kw)
    rows = []
    eng.logits_sink = lambda uid, row: rows.append(
        (uid, np.array(row, copy=True)))
    for uid, prompt, max_new, frames in requests:
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new,
                           frames=frames))
    streams = {r.uid: list(r.tokens) for r in eng.run()}
    lcfg = eng.generations[-1].cfg
    return dict(streams=streams, rows=rows, whole=eng.kept_whole,
                heads=(lcfg.n_heads, lcfg.n_kv_heads),
                audit=[(f.code, f.severity)
                       for f in audit_engine_sharding(eng)])


def family_train(mesh, cfg, params_np, masks_np, batches, lr):
    """Two AdamW steps of ``cfg`` on ``mesh`` through ``train_loss``
    (``masked`` over the local masks, the weights masked first): the
    first batch's loss (and ``sharded_loss`` of it) and gradients, both
    steps' losses and the parameters after them, gathered to full
    shapes; the replicated leaves' local bits; how many leaves the rank
    holds a shard of."""
    from repro_torch.distributed.tensor_parallel import (data_grad_sum,
                                                         data_rows, localize,
                                                         train_loss,
                                                         train_scope)
    from repro_torch.optim import adamw, constant, masked
    from repro_torch.train.loop import _value_and_grad, make_train_step

    params = _bridge.params_from_numpy(params_np, device="cpu")
    masks = _bridge.params_from_numpy(masks_np, device="cpu")
    params = _bridge.apply_masks(params, masks)
    rules = mesh_rules(mesh, cfg)
    model = ShardedModel.from_full(params, cfg, rules)
    opt = masked(adamw(constant(lr)),
                 localize(masks, model.shardings, contiguous=False))
    loss, scope = train_loss(model), train_scope(model)
    rows = [data_rows(b, rules) for b in batches]
    with scope(model.params):
        l0, metrics, g = _value_and_grad(loss, model.params, rows[0])
    l0, g = data_grad_sum(rules)(l0, g)
    forward_loss = sharded_loss(model, batches[0])
    step = make_train_step(loss, opt, sharded=model)
    p, st, losses = model.params, opt.init(model.params), []
    for b in rows:
        p, st, m = step(p, st, b)
        losses.append(float(m["loss"]))
    replicated = [path for path, sh in tree_flatten_with_path(
        model.shardings) if "model" not in sh.spec]
    local = dict(tree_flatten_with_path(p))
    return dict(loss0=float(l0), sharded_loss=forward_loss,
                aux0=float(metrics["aux"]),
                grads=_gathered(g, model.shardings), losses=losses,
                params=_gathered(p, model.shardings),
                replicated={k: local[k].numpy() for k in replicated},
                sharded=len(model.tp._sharded) if model.tp else 0)


def families_rank(mesh, serve_cases, train_cases, lr):
    """Every family's mesh engine (``serve_cases``: (name, cfg,
    params_np, requests)) and two train steps (``train_cases``: (name,
    cfg, params_np, masks_np, batches)) on this rank's mesh."""
    return dict(
        rank=mesh.get_rank(),
        serve={name: family_serve(mesh, cfg, p, reqs)
               for name, cfg, p, reqs in serve_cases},
        train={name: family_train(mesh, cfg, p, m, b, lr)
               for name, cfg, p, m, b in train_cases})
