"""The port's sharding rules against the reference's (pure spec math, no
process group).

``repro_torch.distributed.sharding.ShardingRules`` must give the same
spec as ``repro.distributed.sharding.ShardingRules`` for every parameter
leaf of every ``list_archs()`` tree (the tiny trees the two packages
build, checked leaf for leaf against each other, and the full-shape
trees, shape-only from the reference's configs), for KV caches, tile
plans, batches and the ZeRO-1 optimizer moments, on the meshes
{1x1, 1x2, 2x1, 2x4, 16x16, 2x16x16}, with and without ``head_dim``.
The port reads a duck-typed mesh (``axis_names`` and a ``shape`` dict,
as ``tests/test_sharding.py``'s fake), the reference a device-free
``jax.sharding.AbstractMesh`` of the same axes.  Also: placements, ``place``
and the port's ``shard_plan`` rows against a rank's own local plan.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.api.registry import make_adapter as r_make_adapter
from repro.configs import get_arch as r_get_arch
from repro.configs import list_archs as r_list_archs
from repro.core.masks import path_str as r_path_str
from repro.distributed.sharding import ShardingRules as RRules
from repro_torch.api.registry import make_adapter
from repro_torch.configs import get_arch, list_archs
from repro_torch.core.masks import tree_flatten_with_path
from repro_torch.distributed.sharding import (LeafSharding, Replicate, Shard,
                                              ShardingRules, place,
                                              spec_placements)
from repro_torch.kernels.bsmm import make_tile_plan

MESHES = [{"data": 1, "model": 1}, {"data": 1, "model": 2},
          {"data": 2, "model": 1}, {"data": 2, "model": 4},
          {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]


class FakeMesh:
    """Duck-typed mesh for pure spec tests (no devices, no group)."""

    def __init__(self, shape, coord=None):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self._coord = coord

    def get_coordinate(self):
        return self._coord


def _mesh_id(m):
    return "x".join(str(v) for v in m.values())


def _ref_leaves(tree):
    out = []
    jax.tree_util.tree_map_with_path(
        lambda p, l: out.append((r_path_str(p), tuple(l.shape))), tree)
    return out


def _rules(axes, head_dim):
    return (ShardingRules(FakeMesh(axes), head_dim=head_dim),
            RRules(AbstractMesh(tuple(axes.values()), tuple(axes)),
                   head_dim=head_dim))


@pytest.fixture(scope="module")
def trees():
    """Every arch's (path, shape) leaves: the tiny trees of both packages
    and the reference's full-shape tree (``jax.eval_shape``: nothing
    large is allocated)."""
    assert list_archs() == r_list_archs()
    out = {}
    for arch in list_archs():
        ad = make_adapter(arch, scale="tiny", device="cpu")
        tiny = [(p, tuple(l.shape)) for p, l in tree_flatten_with_path(
            ad.init_params(torch.Generator().manual_seed(0)))
            if l is not None]
        rad = r_make_adapter(arch, scale="tiny")
        rtiny = _ref_leaves(jax.eval_shape(
            lambda: rad.init_params(jax.random.PRNGKey(0))))
        rfull = r_make_adapter(arch, scale="full")
        full = _ref_leaves(jax.eval_shape(
            lambda: rfull.init_params(jax.random.PRNGKey(0))))
        out[arch] = dict(tiny=tiny, rtiny=rtiny, full=full,
                         head_dim=get_arch(arch).head_dim_,
                         rhead_dim=r_get_arch(arch).head_dim_)
    return out


@pytest.mark.parametrize("with_head_dim", [False, True])
@pytest.mark.parametrize("axes", MESHES, ids=_mesh_id)
def test_param_and_zero1_specs_match_reference(trees, axes, with_head_dim):
    for arch, t in trees.items():
        assert sorted(t["tiny"]) == sorted(t["rtiny"]), arch
        assert t["head_dim"] == t["rhead_dim"]
        hd = t["head_dim"] if with_head_dim else None
        ours, ref = _rules(axes, hd)
        for scale in ("tiny", "full"):
            for path, shape in t[scale]:
                try:
                    want = tuple(ref.param_spec(path, shape))
                except IndexError:
                    # the reference's expert rule on a 2-D shared-expert
                    # leaf: the port reads it as the MLP leaf it is
                    assert "/moe/shared/" in path and len(shape) == 2
                    mlp = path.replace("/moe/shared/", "/mlp/")
                    want = tuple(ref.param_spec(mlp, shape))
                assert ours.param_spec(path, shape) == want, \
                    (arch, scale, path, shape, want)
        # ZeRO-1 moments (and an un-sharded step counter)
        opt = {"m": {}, "v": {},
               "count": jax.ShapeDtypeStruct((), np.int32)}
        for path, shape in t["full"]:
            key = path.replace("/", ".")
            opt["m"][key] = jax.ShapeDtypeStruct(shape, np.float32)
            opt["v"][key] = jax.ShapeDtypeStruct(shape, np.float32)
        got = ours.opt_state_shardings(opt, zero1=True)
        want = ref.opt_state_shardings(opt, zero1=True)
        got, want = tree_flatten_with_path(got), _ref_named(want)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (p, sh), (_, rsh) in zip(got, want):
            assert sh.spec == tuple(rsh.spec), (arch, p)


def _ref_named(tree):
    out = []
    jax.tree_util.tree_map_with_path(
        lambda p, s: out.append((r_path_str(p), s)), tree)
    return out


@pytest.mark.parametrize("with_head_dim", [False, True])
@pytest.mark.parametrize("axes", MESHES, ids=_mesh_id)
def test_cache_plan_batch_specs_match_reference(trees, axes, with_head_dim):
    ours, ref = _rules(axes, 128 if with_head_dim else None)
    from repro_torch.models import transformer as tfm
    shapes = [(128, 32768, 32, 128), (128, 32768, 8, 128),
              (28, 8, 4096, 8, 128), (1, 524288, 8, 128), (8,), (),
              (4, 16, 512), (61, 32, 4096, 576), (26, 4224, 1, 256)]
    for arch in ("llama3.2-3b", "qwen2-72b", "llama4-maverick-400b-a17b",
                 "recurrentgemma-2b", "deepseek-v3-671b"):
        for batch in (1, 8, 32):
            spec = tfm.cache_spec(get_arch(arch), batch, 4096)
            shapes += [tuple(l.shape) for _, l in
                       tree_flatten_with_path(spec) if l is not None]
    for shape in shapes:
        assert ours.cache_spec("c", shape) == \
            tuple(ref.cache_spec("c", shape)), shape
    for name in ("idx", "counts", "idx_t", "counts_t", "kk", "nn"):
        for shape in ((64,), (64, 24), (24, 7), (3,), (1, 1), (4096,)):
            assert ours.plan_spec(name, shape) == \
                tuple(ref.plan_spec(name, shape)), (name, shape)
    for shape in ((256, 4096), (1, 4096), (8,), (48, 16, 512), (2, 3), ()):
        assert ours.batch_spec(shape) == tuple(ref.batch_spec(shape)), shape


def test_placements_and_place():
    mesh = FakeMesh({"data": 2, "model": 4}, coord=(1, 3))
    spec = (("data",), None, "model")
    pl = spec_placements(mesh, spec)
    assert pl == (Shard(0), Shard(2))           # one per mesh dim
    assert spec_placements(mesh, (None, "model")) == (Replicate(), Shard(1))
    full = torch.arange(4 * 3 * 8).reshape(4, 3, 8)
    got = place(full, LeafSharding(mesh, spec, pl))
    assert torch.equal(got, full[2:4, :, 6:8])
    # two mesh axes on one dim split it outer-first (pod, then data)
    mesh3 = FakeMesh({"pod": 2, "data": 2, "model": 1}, coord=(1, 0, 0))
    spec = (("pod", "data"), None)
    sh = LeafSharding(mesh3, spec, spec_placements(mesh3, spec))
    assert torch.equal(place(torch.arange(8).reshape(8, 1), sh),
                       torch.arange(4, 6).reshape(2, 1))
    with pytest.raises(ValueError, match="split"):
        place(torch.zeros(3, 3, 8), LeafSharding(mesh, (None, None, "model"),
                                                 (Replicate(), Shard(1))))


@pytest.mark.parametrize("kind", ["col", "row"])
def test_local_plan_rows_equal_plan_spec_rows(kind):
    """A rank's plan built from its own mask shard: where the shard falls
    on 128-tile boundaries, its forward ``idx``/``counts`` (column
    split) or transposed ``idx_t``/``counts_t`` (row split) are the rows
    ``shard_plan`` gives that rank of the full plan."""
    rng = np.random.RandomState(0)
    K, N = 512, 1024
    mask = np.kron(rng.rand(K // 128, N // 128) < 0.4,
                   np.ones((128, 128))).astype(np.float32)
    full = make_tile_plan(mask)
    for r in range(2):
        mesh = FakeMesh({"data": 1, "model": 2}, coord=(0, r))
        rules = ShardingRules(mesh)
        spec = (None, "model") if kind == "col" else ("model", None)
        local_mask = place(torch.from_numpy(mask),
                           LeafSharding(mesh, spec,
                                        spec_placements(mesh, spec))).numpy()
        local = make_tile_plan(local_mask)
        cut = rules.shard_plan({"w": full})["w"]
        a, c = ("idx", "counts") if kind == "col" else ("idx_t", "counts_t")
        assert np.array_equal(getattr(local, c), cut[c])
        for row, n in enumerate(cut[c]):
            assert np.array_equal(getattr(local, a)[row, :n], cut[a][row, :n])
