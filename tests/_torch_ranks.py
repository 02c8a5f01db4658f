"""Rank bodies for ``tests/test_torch_distributed.py``.

``launch.mesh.run_ranks`` starts each rank in a fresh (spawned) process
that imports its function by module path, so these live apart from the
test file: this module imports neither JAX nor the reference package.
Every function takes the rank's mesh first and returns plain Python and
numpy values, which the test compares with the single-device runs.
"""
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
