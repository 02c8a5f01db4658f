"""Training on a tensor-parallel mesh against the reference's
single-device train step.

The port trains rank-local: each rank holds its shards, the backward's
collectives are Megatron's conjugate operators
(``distributed.tensor_parallel``: copy-to-model, reduce-from-model,
gather-from-model), the loss is the global token mean and the gradients
are summed over the data axes before the update.  Two float32 AdamW
steps of llama3.2-3b scaled so that every projection's shard tiles at
128 on a model axis of 2 (4 heads of 128, 2 kv heads, d_ff 512) run on
CPU gloo meshes (1, 2), (2, 1) and (2, 2), dense and through a tile
ticket (the local plans' dx/dw, the masked optimizer), and with one kv
head (K/V kept whole on every model rank).  Each batch carries a loss
mask whose count differs between the data shards.

Tolerances: the loss and the gradients of the first batch at 1e-5; the
losses of both steps at 1e-5; the parameters after both steps at 1e-5
wherever the first gradient is at least ``TINY`` in magnitude.  AdamW's
first steps move a coordinate by about the learning rate times the sign
of its gradient (``g / (|g| + eps)``), so where a gradient is within
rounding of zero two summation orders can move it by up to twice the
rate a step: there the parameters are held to ``2 * LR * steps``, and
the gradients themselves are held at 1e-5 above.  Replicated leaves are
bitwise equal on every rank.  On a data axis the same two steps under
ZeRO-1 (each data rank updating its part of every leaf, the gradients
reduce-scattered and the parameters all-gathered) are bitwise the
tensor-parallel trainer's.  The ranks' bodies live in
``tests/_torch_ranks.py`` (no JAX there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as ranks
import repro_torch.configs as tcfgs
from repro import optim as ropt
from repro.configs import get_arch, scaled_down
from repro.core import masks as rmasks
from repro.models import transformer as rtfm
from repro.train.loop import make_train_step as r_make_train_step
from repro.train.plans import lm_train_plan as r_lm_train_plan
from repro_torch.launch.mesh import run_ranks

SMALL = dict(dtype="float32", n_layers=2, d_model=256, n_heads=4,
             n_kv_heads=2, head_dim=128, d_ff=512)
PROJ = ("wq", "wk", "wv", "wo", "up", "gate", "down")
LR = 1e-4
TOL = dict(rtol=1e-5, atol=1e-5)
TINY = 1e-6             # |first gradient| below which Adam's sign is rounding
B, S = 4, 16


def _ticket(params_np, seed=0, density=0.5):
    """One random 128x128 tile bitmap per projection and layer, column
    tile 0 dead."""
    rng = np.random.default_rng(seed)

    def mk(path, a):
        if str(path[-1].key) not in PROJ:
            return None
        *lead, K, N = a.shape
        bm = rng.random((*lead, K // 128, N // 128)) < density
        bm[..., 0] = False
        return np.repeat(np.repeat(bm, 128, -2), 128, -1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(mk, params_np)


def _batches(vocab):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(2):
        mask = np.ones((B, S), np.float32)
        mask[: B // 2, S // 4:] = 0         # data shard 0 counts fewer
        out.append({"tokens": rng.integers(0, vocab, (B, S), np.int32),
                    "labels": rng.integers(0, vocab, (B, S), np.int32),
                    "loss_mask": mask})
    return out


def _by_path(tree):
    return {rmasks.path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _reference(rcfg, params_np, masks, batches):
    """The reference's single-device step: the first batch's loss and
    grads, then two steps' losses and the parameters after them."""
    params = jax.tree.map(jnp.asarray, params_np)
    plan = None
    opt = ropt.adamw(ropt.constant(LR))
    if masks is not None:
        params = rmasks.apply_masks(params, masks)
        plan = r_lm_train_plan(masks, interpret=True)[0]
        opt = ropt.masked(opt, masks)

    def loss(p, b):
        return rtfm.loss_fn(p, rcfg, b, plan=plan)

    jb = [jax.tree.map(jnp.asarray, b) for b in batches]
    (l0, _), g0 = jax.value_and_grad(loss, has_aux=True)(params, jb[0])
    step = r_make_train_step(loss, opt, donate=False)
    p, st, losses = params, opt.init(params), []
    for b in jb:
        p, st, m = step(p, st, b)
        losses.append(float(m["loss"]))
    return dict(loss0=float(l0), grads=_by_path(g0), losses=losses,
                params=_by_path(p))


@pytest.fixture(scope="module")
def setup():
    out = {}
    for name, kw in (("dense", SMALL), ("masked", SMALL),
                     ("kv1", dict(SMALL, n_kv_heads=1))):
        rcfg = scaled_down(get_arch("llama3.2-3b"), **kw)
        tcfg = tcfgs.scaled_down(tcfgs.get_arch("llama3.2-3b"), **kw)
        params_np = jax.tree.map(
            np.asarray, rtfm.init_params(jax.random.PRNGKey(0), rcfg))
        masks = _ticket(params_np) if name == "masked" else None
        out[name] = (rcfg, tcfg, params_np, masks)
    batches = _batches(out["dense"][1].vocab_size)
    refs = {k: _reference(v[0], v[2], v[3], batches) for k, v in out.items()}
    return out, batches, refs


MESHES = {(1, 2): ("dense", "masked", "kv1"), (2, 1): ("dense", "masked"),
          (2, 2): ("dense", "masked")}


@pytest.fixture(scope="module")
def runs(setup):
    cells, batches, _ = setup
    got = {}
    for (d, m), names in MESHES.items():
        scen = [(cells[n][1], cells[n][2], cells[n][3]) for n in names]
        res = run_ranks(ranks.tp_train_rank, d, m, device="cpu",
                        args=(scen, batches, LR))
        for i, n in enumerate(names):
            got[(d, m, n)] = [r[i] for r in res]
    return got


CASES = [(d, m, n) for (d, m), names in MESHES.items() for n in names]


@pytest.mark.parametrize("d,m,name", CASES)
def test_tp_train_matches_single_device_reference(d, m, name, setup, runs):
    cells, _, refs = setup
    want, per_rank = refs[name], runs[(d, m, name)]
    got = per_rank[0]
    np.testing.assert_allclose(got["loss0"], want["loss0"], **TOL)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], g, err_msg=k, **TOL)
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
    for k, p in want["params"].items():
        firm = np.abs(want["grads"][k]) >= TINY
        np.testing.assert_allclose(got["params"][k][firm], p[firm],
                                   err_msg=k, **TOL)
        assert np.all(np.abs(got["params"][k] - p) <= 2 * LR * 2), k
    # the model axis really shards: the local plans' dx/dw on a ticket,
    # and K/V kept whole with one kv head
    assert (got["sharded"] > 0) == (m > 1)
    masks = cells[name][3]
    if masks is not None:
        for path, mk in rmasks.flat_mask_items(masks):
            assert not np.any(got["params"][path][np.asarray(mk) == 0]), path


@pytest.mark.parametrize("d,m,name", CASES)
def test_replicated_leaves_are_bitwise_equal_on_every_rank(d, m, name, runs):
    per_rank = runs[(d, m, name)]
    assert per_rank[0]["replicated"]
    for r in per_rank[1:]:
        assert sorted(r["replicated"]) == sorted(per_rank[0]["replicated"])
        for k, v in per_rank[0]["replicated"].items():
            assert np.array_equal(r["replicated"][k], v), k
        for k, v in per_rank[0]["params"].items():
            assert np.array_equal(r["params"][k], v), k


@pytest.mark.parametrize("d,m,name", [c for c in CASES if c[0] > 1])
def test_zero1_trainer_is_bitwise_the_tp_trainer(d, m, name, runs):
    for r in runs[(d, m, name)]:
        z = r["zero1"]
        assert z["parted"] > 0          # moments really cut over data
        assert z["losses"] == r["losses"]
        assert sorted(z["params"]) == sorted(r["params"])
        for k, v in r["params"].items():
            assert np.array_equal(z["params"][k], v), k


def test_launcher_trains_on_a_tensor_parallel_mesh(setup):
    """``launch.train.main``'s multi-rank branch on two gloo ranks (the
    production mesh's shape swapped for (1, 2), the arch's config for
    the small one): it builds the rank-local trainer and steps."""
    cfg = setup[0]["dense"][1]
    res = run_ranks(ranks.launcher_rank, 1, 2, device="cpu",
                    args=("llama3.2-3b", cfg))
    assert [r["step"] for r in res] == [2, 2]
    assert res[0]["table_shape"][0] == cfg.padded_vocab // 2
    assert np.array_equal(res[0]["norm"], res[1]["norm"])
    assert np.all(np.isfinite(res[0]["norm"]))


def test_launcher_trains_with_zero1_on_a_data_axis(setup):
    """``launch.train.main --zero1`` on a (2, 1) mesh: each data rank
    holds half of every first moment the rules cut over ``data``, and the
    two ranks' parameters stay equal."""
    cfg = setup[0]["dense"][1]
    res = run_ranks(ranks.launcher_rank, 2, 1, device="cpu",
                    args=("llama3.2-3b", cfg, ("--zero1",)))
    assert [r["step"] for r in res] == [2, 2]
    # the rules give the vocab dim to ``model``, so ``data`` cuts d_model
    assert res[0]["moment_shape"] == (res[0]["table_shape"][0],
                                      res[0]["table_shape"][1] // 2)
    assert np.array_equal(res[0]["norm"], res[1]["norm"])
