"""Rank-local tensor parallelism (Megatron's form) over a mesh's
``model`` axis.

Each rank holds its own shard of every parameter the sharding rules
split and runs the model on local shapes; collectives sit only at the
shard boundaries:

  * column-parallel leaves (``wq/wk/wv/up/gate``) compute this rank's
    columns — attention keeps its local heads, the MLP its local
    ``d_ff`` columns (a replicated bias is cut to the same columns);
  * row-parallel leaves (``wo/down``) take the local input slice and
    finish with an ``all_reduce`` over ``model`` (a bias is added once,
    after it);
  * the vocab-parallel ``table`` does a masked local lookup plus an
    ``all_reduce``, and the unembedding makes local logits, then an
    ``all_gather``;
  * stacked MoE experts split over ``model`` (expert parallelism): each
    rank runs its experts' rows, then the outputs are gathered;
  * MLA shards its heads (``w_uq``, ``w_uk``, ``w_uv`` and ``wo``); its
    down-projections ``w_dq``/``w_dkv``, their norms and the latent
    cache stay whole on every rank, since every head reads the latent;
  * the RG-LRU runs channel-parallel: ``w_in``/``w_gate`` column
    shards, its block-diagonal gates on the local blocks, the conv, Λ
    and the decode state at the local channels, ``w_out`` row-parallel;
    the recurrence is per channel, so no collective sits inside it;
  * the mLSTM shards its heads: ``up``/``gate`` columns, the
    block-diagonal q/k/v on the local blocks, the gate projections
    ``wi``/``wf`` on the local heads — each head's gate reads all of the
    up-projection, so that is gathered first — and ``down``
    row-parallel;
  * the sLSTM shards its heads inside the cell: ``wi/wf/wz`` columns,
    the block-diagonal recurrences on the local blocks, and ``wo``,
    which the rules cut by rows, as a row-parallel product cut to the
    local channels (reduce-scatter); the cell's output is gathered and
    the post-cell ``up``/``down`` stay whole (the rules' contiguous
    column cut of ``up`` would not pair its gelu and value halves);
  * the encoder-decoder shards its self- and cross-attention heads as
    GQA does, and its MLP as the MLP does; ``frame_adapter`` stays whole.

A block the rank-local model cannot run on a shard stays whole on every
model rank ("kept whole against its spec", listed by ``layout``): an
MLP whose ``d_ff`` does not divide (the rules' fallback splits its
input dim), a recurrent block whose heads or blocks do not divide, and
any block with a block-sparse projection whose shard would split a
128-tile — ``plan_matmul`` needs its plan to cover the weight, so that
projection runs on the full weight with the full plan, which is what
GSPMD does to the reference's Pallas custom call.  A replicated leaf a
sharded block reads at its local channels (a bias, Λ, a stacked
RG-LRU's conv, whose rules put ``model`` on the repeats axis) is cut at
use.  Attention shards as two groups: q (``wq``/``wo``, Hq/M heads a
rank) and K/V (``wk``/``wv``).  When the K/V heads do not divide (or
their shard would cut a tile) K/V stay whole on every model rank with
their caches, and each rank attends its local q heads against the kv
heads they map to (its q heads placed among zero heads, the other
heads' outputs dropped); when the q heads do not divide, the whole
attention stays whole (in the encoder-decoder, whose encoder and cross
attention read only local K/V, q shards only with K/V).  Nothing drops
to dense: each rank's plans are built from its own mask shard, which is
exact because pruned weights are exact zeros.

Collectives go through ``collective``: the one place where a gloo group
(two ranks sharing a card) stages CUDA tensors through host memory, and
where a ``launch.hlo_analysis.StepTrace`` records them on fake tensors.

Training on a mesh uses Megatron's conjugate operators
(``torch.autograd.Function``s over ``collective``), entered only while
autograd records, so that serving runs the collectives alone:

  * copy-to-model (``TensorParallel.copy_in``): identity forward,
    ``all_reduce`` backward — on the input of each column-parallel group
    (q and sharded K/V, the MLP's up/gate, the unembedding, the experts'
    rows, the recurrent blocks' inputs, MLA's latents), on a replicated
    leaf cut to local columns, and on K/V kept whole (each rank's heads
    read all of them);
  * reduce-from-model: ``all_reduce`` forward, identity backward — the
    row-parallel output and the vocab-parallel lookup;
  * gather-from-model: ``all_gather`` forward, this rank's slice
    backward — the unembedding's logits, the experts' outputs and the
    sLSTM cell's output;
  * gather-to-local (``gather_local``): ``all_gather`` forward,
    reduce-scatter backward — the mLSTM's up-projection its local gates
    read whole;
  * reduce-to-local (``row_local``): reduce-scatter forward,
    ``all_gather`` backward — the sLSTM's output-gate projection.

So every replicated leaf gets the same gradient on every model rank.
``train_loss`` is the global token mean (each data rank's token-loss
sum over the global token count) and ``data_grad_sum`` sums the
gradients over the data axes before the optimizer, so that unequal loss
masks still give the single-device gradient.  The MoE aux loss is
global over the batch too: each data rank sums its layers' token
statistics over the data axes (``hooks.moe_aux_sum``, an ``all_reduce``
whose backward is an ``all_reduce``) and adds 1/D of the aux loss, so
that the summed loss counts it once and every rank's gradient is its
own tokens' share of the global one.  ZeRO-1 (``Zero1``) cuts the
optimizer state over ``data`` instead: each gradient is
reduce-scattered to the data rank's part, the update runs on that part,
and the parameter is all-gathered back.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.configs.base import (MLSTM, MXU_TILE, RGLRU, SLSTM,
                                      ArchConfig)
from repro_torch.core.masks import tree_map_with_path
from repro_torch.distributed.sharding import (LeafSharding, ShardingRules,
                                              place, spec_placements)
from repro_torch.kernels import _mark
from repro_torch.kernels.bsmm import plan_matmul
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models import hooks


def collective(op: str, t: torch.Tensor, group, **kw) -> torch.Tensor:
    """Run ``all_reduce`` (in place, sum), ``all_gather`` (returns the
    list's concatenation along ``dim``), ``reduce_scatter`` (returns
    this rank's part of the sum along ``dim``) or ``broadcast`` (in
    place, from global rank ``src``) of ``t`` over ``group``.  A gloo group
    with a CUDA tensor stages it through host memory (gloo may lack the
    CUDA path of a collective); the kernels' tensors never leave the
    card otherwise.  A fake ``t`` under an active ``StepTrace`` is
    recorded there and nothing is sent."""
    if isinstance(t, FakeTensor):
        if _mark.trace is None:
            raise RuntimeError("a fake tensor reached a collective with no "
                               "StepTrace active")
        return _mark.trace.collective(op, t, group, **kw)
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    h = t.cpu() if staged else t
    if op == "all_gather":
        parts = [torch.empty_like(h) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, h.contiguous(), group=group)
        out = torch.cat(parts, dim=kw.get("dim", 0))
        return out.to(t.device) if staged else out
    if op == "reduce_scatter":            # the sum, this rank's part
        whole = collective("all_reduce", t.clone(), group)
        dim = kw.get("dim", 0)
        n = t.shape[dim] // dist.get_world_size(group)
        return whole.narrow(dim, dist.get_rank(group) * n, n).contiguous()
    if op == "all_reduce":
        dist.all_reduce(h, group=group)
    elif op == "broadcast":
        dist.broadcast(h, src=kw["src"], group=group)
    else:
        raise ValueError(f"unknown collective {op!r}")
    if staged:
        t.copy_(h)
    return t


def _storage(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (views of a stacked leaf share
    it; a fake or meta storage has one too, where its data pointer is
    0)."""
    return t.untyped_storage()._cdata


def _recording(t) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collective("all_reduce", g.contiguous().clone(),
                          ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """``all_reduce`` forward; the gradient passes through."""

    @staticmethod
    def forward(ctx, x, group):
        return collective("all_reduce", x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """``all_gather`` along ``dim`` forward; this rank's slice of the
    gradient backward."""

    @staticmethod
    def forward(ctx, x, group, dim, rank):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        return collective("all_gather", x.contiguous(), group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(),
                None, None, None)


class _GatherToLocal(torch.autograd.Function):
    """``all_gather`` along ``dim`` forward, every rank reading the whole
    for its own outputs; backward the gradient summed over the model
    axis, this rank's slice (reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return collective("all_gather", x.contiguous(), group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (collective("reduce_scatter", g.contiguous(), ctx.group,
                           dim=ctx.dim), None, None)


class _ReduceToLocal(torch.autograd.Function):
    """The sum over the model axis cut to this rank's slice along ``dim``
    forward (reduce-scatter); backward the slices' gradients gathered."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return collective("reduce_scatter", x.contiguous(), group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (collective("all_gather", g.contiguous(), ctx.group,
                           dim=ctx.dim), None, None)


class _SumOverData(torch.autograd.Function):
    """``all_reduce`` over each data group forward; the gradient summed
    the same way backward (every data rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _sum_over(x.contiguous().clone(), groups)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g.contiguous().clone(), ctx.groups), None


def _sum_over(t, groups):
    for g in groups:
        t = collective("all_reduce", t, g)
    return t


class TensorParallel:
    """This rank's view of the ``model`` axis: its group, rank and size,
    and which parameter storages hold a shard (views of a stacked leaf
    share its storage, so a repeat's slice is recognised too)."""

    def __init__(self, mesh, sharded_leaves=()):
        self.group = mesh.get_group("model")
        self.size = mesh_axes(mesh)["model"]
        self.rank = mesh.get_local_rank("model")
        self.bind(sharded_leaves)

    def bind(self, sharded_leaves) -> None:
        """Recognise ``sharded_leaves`` as this rank's shards (an
        optimizer step makes new parameter tensors: a train step binds
        its own)."""
        self._sharded: Dict[int, torch.Tensor] = {}
        for t in sharded_leaves:
            self._sharded[_storage(t)] = t

    def is_sharded(self, w) -> bool:
        return w is not None and _storage(w) in self._sharded

    def all_reduce(self, t):
        """Sum over ``model`` (reduce-from-model while autograd records)."""
        if _recording(t):
            return _ReduceFromModel.apply(t, self.group)
        return collective("all_reduce", t.contiguous(), self.group)

    def all_gather(self, t, dim: int):
        """Concatenate over ``model`` (gather-from-model while autograd
        records)."""
        if _recording(t):
            return _GatherFromModel.apply(t, self.group, dim % t.ndim,
                                          self.rank)
        return collective("all_gather", t.contiguous(), self.group, dim=dim)

    def gather_local(self, t, dim: int):
        """Every rank's slice of ``t`` along ``dim``, concatenated, where
        each rank reads the whole for its own outputs (gather-to-local
        while autograd records: the gradient's sum over ``model``, cut
        to this rank's slice)."""
        if _recording(t):
            return _GatherToLocal.apply(t, self.group, dim % t.ndim)
        return collective("all_gather", t.contiguous(), self.group, dim=dim)

    def row_local(self, x, w):
        """``x @ w`` for a ``w`` cut by rows (its input dim), read only at
        this rank's output columns: the local input slice times the
        local rows, summed over ``model`` and cut to this rank's columns
        (reduce-to-local while autograd records).  ``x`` is whole, through
        ``copy_in``."""
        n = w.shape[-2]
        part = x.narrow(-1, self.rank * n, n) @ w
        if _recording(part):
            return _ReduceToLocal.apply(part, self.group, part.ndim - 1)
        return collective("reduce_scatter", part.contiguous(), self.group,
                          dim=-1)

    def cut(self, v):
        """A replicated leaf ``v`` a sharded block reads at its local
        columns: this rank's columns, its gradient summed over
        ``model``."""
        return self.cols(self.copy_in(v))

    def copy_in(self, t):
        """The input of a column-parallel group (copy-to-model): ``t``
        itself, its gradient summed over ``model`` while autograd
        records."""
        if t is None or not _recording(t):
            return t
        return _CopyToModel.apply(t, self.group)

    def cols(self, v):
        """This rank's slice of the last dim of a replicated ``v``."""
        n = v.shape[-1] // self.size
        return v.narrow(-1, self.rank * n, n)

    def pad_heads(self, q):
        """The local query heads (dim -2) at their global positions among
        zero heads: all Hq heads, to attend K/V kept whole."""
        h = q.shape[-2]
        shape = list(q.shape)
        shape[-2] = h * self.size
        full = q.new_zeros(shape)
        full.narrow(-2, self.rank * h, h).copy_(q)
        return full

    def local_heads(self, out, h: int):
        """This rank's ``h`` heads (dim -2) of an all-heads output."""
        return out.narrow(-2, self.rank * h, h)

    # -- the projections ---------------------------------------------------
    def col(self, x, w, plan, bias=None, act=None):
        """Column-parallel: this rank's columns of ``x @ w`` (``x`` is
        the group's input, already through ``copy_in``)."""
        return plan_matmul(
            x, w, plan,
            bias=None if bias is None else self.cut(bias),
            act=act)

    def row(self, x, w, plan, bias=None):
        """Row-parallel: the local partial product, summed over
        ``model``; the bias is added once, after the sum."""
        y = self.all_reduce(plan_matmul(x, w, plan))
        return y if bias is None else y + bias

    def embed(self, table, tokens):
        """Vocab-parallel lookup: rows this rank owns, zeros elsewhere,
        summed over ``model`` (one non-zero term: exact)."""
        v = table.shape[0]
        local = tokens - self.rank * v
        own = (local >= 0) & (local < v)
        x = table[local.clamp(0, v - 1)] * own[..., None].to(table.dtype)
        return self.all_reduce(x)

    def unembed(self, table, x):
        """Local logits over this rank's vocab rows, gathered."""
        return self.all_gather(self.copy_in(x) @ table.T, dim=-1)


# ---------------------------------------------------------------------------
# Layout: which leaves shard, which stay whole
# ---------------------------------------------------------------------------
def _tiles(shape, tile: int = MXU_TILE) -> bool:
    return shape[-1] % tile == 0 and shape[-2] % tile == 0


# the tensor dim each block kind's leaves shard on over the model axis
# (keyed by the leaf's path within its block); a leaf of a block runs
# sharded only when its spec puts "model" there and nowhere else (the
# rules' fallbacks to another dim are kept whole)
_SHARD_DIM = {
    "attn": {"wq": -1, "wk": -1, "wv": -1, "wo": -2},
    "mla": {"w_uq": -1, "w_uk": -1, "w_uv": -1, "wo": -2},
    "mlp": {"up": -1, "gate": -1, "down": -2},
    "experts": {"up": -3, "gate": -3, "down": -3},
    "table": {"table": -2},
    "rglru": {"w_in": -1, "w_gate": -1, "w_out": -2, "rg/w": -3,
              "ig/w": -3, "conv/w": -1},
    "mlstm": {"up": -1, "gate": -1, "down": -2, "cell/wq/w": -3,
              "cell/wk/w": -3, "cell/wv/w": -3, "cell/wi": -1,
              "cell/wf": -1},
    "slstm": {"cell/wi": -1, "cell/wf": -1, "cell/wz": -1, "cell/wo": -2,
              "cell/ri/w": -3, "cell/rf/w": -3, "cell/rz/w": -3,
              "cell/ro/w": -3},
}
# leaves a block runs sharded with when their spec lands on the block's
# dim, and otherwise keeps whole and cuts at use: a stacked RG-LRU's conv,
# whose rules put "model" on the repeats axis
_CUT_AT_USE = {("rglru", "conv/w")}
_RNN_KINDS = {RGLRU: "rglru", MLSTM: "mlstm", SLSTM: "slstm"}


def _layer_kinds(cfg: ArchConfig) -> Dict[str, str]:
    """{"segments/s/p": the block kind} of a decoder-only model."""
    if cfg.is_encoder_decoder:
        return {}
    from repro_torch.models.transformer import segments_of
    return {f"segments/{s}/{p}": sig[0]
            for s, seg in enumerate(segments_of(cfg))
            for p, sig in enumerate(seg.sigs)}


def _block_of(path: str, cfg: ArchConfig, kinds: Dict[str, str]):
    """(block key, kind, the leaf's name in its block) of a leaf that
    shards with a block, else None.  Attention keys q (``wq``/``wo``)
    and K/V apart."""
    comps = path.split("/")
    name = comps[-1]
    if name == "table":
        return path, "table", name
    if "rnn" in comps:
        i = comps.index("rnn")
        prefix = "/".join(comps[:i])
        kind = _RNN_KINDS.get(kinds.get(prefix))
        sub = "/".join(comps[i + 1:])
        if kind is not None and sub in _SHARD_DIM[kind]:
            return prefix + "/rnn", kind, sub
        return None
    parent = "/".join(comps[:-1])
    owner = comps[-2] if len(comps) > 1 else ""
    if owner == "attn" and cfg.mla is not None:
        return (parent, "mla", name) if name in _SHARD_DIM["mla"] else None
    if owner in ("attn", "xattn") and name in _SHARD_DIM["attn"]:
        return (parent + ("/q" if name in ("wq", "wo") else "/kv"), "attn",
                name)
    if owner == "moe" and name in _SHARD_DIM["experts"]:
        return parent, "experts", name
    if owner in ("mlp", "shared") and name in _SHARD_DIM["mlp"]:
        return parent, "mlp", name
    return None


def mesh_rules(mesh, cfg: ArchConfig) -> ShardingRules:
    """The rules a model of ``cfg`` runs under on ``mesh`` (the head
    guard at its head width)."""
    return ShardingRules(mesh, head_dim=cfg.head_dim_)


def layout(params, cfg: ArchConfig, rules: ShardingRules, masks=None):
    """(shardings, whole): a ``LeafSharding`` per leaf as the rank-local
    model runs it — the rules' spec where the leaf's block runs sharded,
    Replicate where the block stays whole — and [(path, spec)] of the
    leaves kept whole against their spec.  The one placement decision:
    the engine, ``ShardedModel`` and ``elastic_restore`` all take it
    from here."""
    m = rules.tp_size
    kinds = _layer_kinds(cfg)
    masked = set()
    if masks is not None:
        tree_map_with_path(lambda p, l: l is not None and masked.add(p),
                           masks)
    specs: Dict[str, tuple] = {}
    fits: Dict[str, bool] = {}      # leaf -> its spec lands on its dim
    ok: Dict[str, bool] = {}        # block key -> runs sharded
    kind_of: Dict[str, str] = {}

    def visit(path, leaf):
        if leaf is None:
            return
        shape = tuple(leaf.shape)
        spec = specs[path] = rules.param_spec(path, shape)
        blk = _block_of(path, cfg, kinds)
        if blk is None:
            return
        key, kind, sub = blk
        dim = len(shape) + _SHARD_DIM[kind][sub]
        good = spec[dim] == "model" and spec.count("model") == 1
        if good and kind in ("attn", "mlp") and path in masked \
                and _tiles(shape):
            # a block-sparse projection whose shard would cut a 128-tile
            local = tuple(n // m if e == "model" else n
                          for n, e in zip(shape, spec))
            good = _tiles(local)
        fits[path] = good
        kind_of[key] = kind
        if (kind, sub) not in _CUT_AT_USE:
            good = good and (kind != "mla" or cfg.n_heads % m == 0)
            ok[key] = ok.get(key, True) and good
        else:
            ok.setdefault(key, True)

    tree_map_with_path(visit, params)
    # one q, one kv and one MLA head count for every attention layer;
    # K/V shard only with the q heads (in the encoder-decoder, q only
    # with K/V: its encoder and cross attention read local K/V alone)
    q_ok = all(v for k, v in ok.items() if k.endswith("attn/q"))
    kv_ok = q_ok and all(v for k, v in ok.items() if k.endswith("attn/kv"))
    if cfg.is_encoder_decoder:
        q_ok = kv_ok
    mla_ok = all(v for k, v in ok.items() if kind_of[k] == "mla")
    for k in ok:
        if k.endswith("attn/q"):
            ok[k] = q_ok
        elif k.endswith("attn/kv"):
            ok[k] = kv_ok
        elif kind_of[k] == "mla":
            ok[k] = mla_ok
    whole: List[Tuple[str, tuple]] = []

    def mk(path, leaf):
        if leaf is None:
            return None
        spec = specs[path]
        blk = _block_of(path, cfg, kinds)
        runs = blk is not None and ok[blk[0]] and fits[path]
        if m > 1 and "model" in spec and not runs:
            whole.append((path, spec))
            spec = tuple(None if e == "model" else e for e in spec)
        return LeafSharding(rules.mesh, spec,
                            spec_placements(rules.mesh, spec))

    return tree_map_with_path(mk, params), whole


def localize(tree, shardings, *, contiguous: bool = True):
    """Every leaf cut to this rank's shard (masks pass
    ``contiguous=False``: an expanded mask stays a view)."""
    def cut(path, leaf):
        if leaf is None:
            return None
        sh = _lookup(shardings, path)
        if sh is None:
            return leaf
        return place(leaf, sh, contiguous=contiguous)
    return tree_map_with_path(cut, tree)


def _lookup(tree, path: str):
    node = tree
    for k in path.split("/") if path else ():
        if isinstance(node, dict):
            node = node.get(k)
        elif isinstance(node, (list, tuple)):
            node = node[int(k)]
        else:
            return None
        if node is None:
            return None
    return node


def sharded_leaves(local, shardings) -> List[torch.Tensor]:
    """The local leaves whose placement (``layout``'s) shards them over
    ``model``."""
    out: List[torch.Tensor] = []

    def visit(path, leaf):
        sh = _lookup(shardings, path)
        if leaf is not None and sh is not None and "model" in sh.spec:
            out.append(leaf)
        return leaf

    tree_map_with_path(visit, local)
    return out


def _heads_sharded(shardings, leaf: str) -> bool:
    """True when every attention layer's ``leaf`` (``wq``, ``wk`` or
    MLA's ``w_uq``) is placed as a shard of its heads."""
    found = []

    def visit(path, sh):
        if sh is not None and path.endswith(f"/attn/{leaf}"):
            found.append("model" in sh.spec)
        return sh

    tree_map_with_path(visit, shardings)
    return bool(found) and all(found)


def local_config(cfg: ArchConfig, model: int, shardings) -> ArchConfig:
    """The config the rank-local model runs: Hq/M query heads and Hkv/M
    kv heads where the placement shards them (the head width stays
    explicit).  The recurrent blocks read their local widths from their
    parameters."""
    q = "w_uq" if cfg.mla is not None else "wq"
    if model == 1 or not _heads_sharded(shardings, q):
        return cfg
    kv = cfg.mla is not None or _heads_sharded(shardings, "wk")
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // model,
        n_kv_heads=cfg.n_kv_heads // model if kv else cfg.n_kv_heads,
        head_dim=cfg.head_dim_)


def _aux_sum(groups):
    """``t -> t`` summed over ``groups`` (``hooks.moe_aux_sum``): its
    gradient summed the same way while autograd records."""
    def total(t):
        if _recording(t):
            return _SumOverData.apply(t, groups)
        return _sum_over(t.contiguous().clone(), groups)
    return total


@contextlib.contextmanager
def scope(rules: Optional[ShardingRules], tp: Optional[TensorParallel],
          groups: Optional[int] = None, data_groups=()):
    """Install ``rules`` (MoE groups — or ``groups`` in their place),
    ``tp`` and, with ``data_groups``, the MoE aux loss's sum over them
    for the duration of a call; whatever was installed before comes back
    afterwards."""
    from repro_torch.distributed import sharding
    prev_rules, prev_tp = sharding.installed(), hooks.tensor_parallel()
    prev_groups, prev_aux = hooks.moe_groups(), hooks.moe_aux_sum()
    sharding.install(rules)
    if groups is not None:
        hooks.set_moe_groups(groups)
    hooks.set_tensor_parallel(tp)
    hooks.set_moe_aux_sum(_aux_sum(list(data_groups)) if data_groups
                          else None)
    try:
        yield
    finally:
        sharding.install(prev_rules)
        hooks.set_moe_groups(prev_groups)
        hooks.set_tensor_parallel(prev_tp)
        hooks.set_moe_aux_sum(prev_aux)


# ---------------------------------------------------------------------------
# A sharded model: local params, local config, context
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ShardedModel:
    params: Any                 # this rank's shards
    cfg: ArchConfig             # the local config (local heads)
    rules: ShardingRules
    tp: Optional[TensorParallel]
    shardings: Any
    whole: List[Tuple[str, tuple]]

    @classmethod
    def from_full(cls, params, cfg: ArchConfig, rules: ShardingRules,
                  masks=None) -> "ShardedModel":
        shardings, whole = layout(params, cfg, rules, masks)
        return cls._build(localize(params, shardings), cfg, rules,
                          shardings, whole)

    @classmethod
    def from_local(cls, local, template, cfg: ArchConfig,
                   rules: ShardingRules, masks=None) -> "ShardedModel":
        """A tree already cut to this rank's shards of the full-shape
        ``template`` (``elastic_restore``'s ``params``, restored with the
        same ``cfg``, mesh and ``masks``)."""
        shardings, whole = layout(template, cfg, rules, masks)
        return cls._build(local, cfg, rules, shardings, whole)

    @classmethod
    def _build(cls, local, cfg, rules, shardings, whole) -> "ShardedModel":
        tp = (TensorParallel(rules.mesh, sharded_leaves(local, shardings))
              if rules.tp_size > 1 else None)
        lcfg = local_config(cfg, rules.tp_size, shardings)
        return cls(local, lcfg, rules, tp, shardings, list(whole))

    def scope(self, groups: Optional[int] = None):
        return scope(self.rules, self.tp, groups)

    def global_scope(self):
        """The scope of a forward every data rank runs over its rows of
        one global batch (a train step, ``sharded_loss``): one MoE
        dispatch group a rank, the aux loss's statistics summed over the
        data axes."""
        return scope(self.rules, self.tp, 1, _data_groups(self.rules))


def data_rows(batch, rules: ShardingRules):
    """This rank's rows of a global batch (numpy or tensor leaves), as
    ``batch_spec`` places them over the data axes."""
    def cut(_, leaf):
        sh = rules.leaf_sharding(rules.batch_spec(tuple(leaf.shape)))
        return place(torch.as_tensor(leaf), sh)
    return tree_map_with_path(cut, batch)


def sharded_loss(model: ShardedModel, batch) -> float:
    """The loss of a global ``batch`` on a mesh (forward only), as the
    model's ``loss_fn`` gives it on one device (the reference's MoE
    dispatch groups at the data-axis size).  Each data rank runs its
    rows through the tensor-parallel model's ``loss_fn`` with the global
    token count as the denominator; the token losses are summed over the
    data axes and the aux term, the global batch's on every rank, is
    added once."""
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tfm
    mod = encdec if model.cfg.is_encoder_decoder else tfm
    groups = _data_groups(model.rules)
    rows = data_rows(batch, model.rules)
    dev = model.params["embed"]["table"].device
    rows = {k: v.to(dev) for k, v in rows.items()}
    mask = rows.get("loss_mask")
    count = (torch.full((), float(rows["labels"].numel()), device=dev)
             if mask is None else mask.float().sum())
    with torch.no_grad(), model.global_scope():
        loss, metrics = mod.loss_fn(model.params, model.cfg, rows,
                                    count=_sum_over(count, groups))
    ce = _sum_over(metrics["ce"].double(), groups)
    return float(ce) + float(loss - metrics["ce"])


# ---------------------------------------------------------------------------
# Training on a mesh
# ---------------------------------------------------------------------------
def _data_groups(rules: ShardingRules) -> list:
    return [rules.mesh.get_group(a) for a in rules.dp_axes
            if rules.axis_sizes[a] > 1]


def train_loss(model: ShardedModel, *, plan=None, aux_weight: float = 0.01):
    """``(params, batch) -> (loss, metrics)`` of this rank's rows on
    ``model``'s mesh, the forward under ``model.global_scope()``.  The
    train step must enter ``train_scope(model)`` around the backward
    too: remat recomputes each layer there, under the same scope.  On one
    data rank it is the model's own ``loss_fn``; over D data ranks the
    global token mean (the same ``loss_fn`` with the token count summed
    over the data axes as its denominator: ``softmax_cross_entropy``'s
    ``count``) plus 1/D of ``aux_weight`` × the global MoE aux loss, so
    that ``data_grad_sum``'s sum of the losses and the gradients is the
    single-device step's on the global batch."""
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tfm
    cfg, rules = model.cfg, model.rules
    groups = _data_groups(rules)
    mod = encdec if cfg.is_encoder_decoder else tfm
    share = rules.dp_size

    def loss(p, batch):
        kw = {} if cfg.is_encoder_decoder else {"plan": plan}
        kw["aux_weight"] = aux_weight / share
        if groups:
            mask = batch.get("loss_mask")
            labels = batch["labels"]
            count = (torch.full((), float(labels.numel()),
                                device=labels.device) if mask is None
                     else mask.float().sum().detach().clone())
            kw["count"] = _sum_over(count, groups)
        with model.global_scope():
            return mod.loss_fn(p, cfg, batch, **kw)

    return loss


def train_scope(model: ShardedModel):
    """``params -> context`` that a mesh's train step enters around its
    forward and backward (``make_train_step(scope=)``): the model's
    ``global_scope`` with the step's own parameters bound as the
    shards."""
    def enter(params):
        if model.tp is not None:
            model.tp.bind(sharded_leaves(params, model.shardings))
        return model.global_scope()
    return enter


class Zero1:
    """ZeRO-1 on a mesh's ``data`` axis: each data rank keeps the optimizer
    state of its part of every leaf and updates only that part.

    A leaf's part is cut on the dim ``ShardingRules.opt_state_shardings``
    puts ``data`` on for the full-shape leaf (the first dim its spec
    leaves whole that the axis divides; None keeps the moments whole).
    The step (``train.loop.make_train_step(zero1=True)``) sums the loss
    over the data axes, all-reduces each gradient over the other data
    axes (``pod``) and reduce-scatters it over ``data`` (all-reduces it
    where the moments stay whole), updates the parts, and all-gathers
    each part back over ``data``.  The optimizer therefore sees parts:
    its state is ``init(part(params))``, and a masked optimizer takes
    ``part(masks)``."""

    def __init__(self, model: "ShardedModel"):
        from repro_torch.core.masks import tree_flatten_with_path
        rules, tp = model.rules, model.rules.tp_size
        self.mesh = rules.mesh
        self.size = rules.axis_sizes.get("data", 1)
        self.rank = self.mesh.get_local_rank("data") if self.size > 1 else 0
        self.others = [self.mesh.get_group(a) for a in rules.dp_axes
                       if a != "data" and rules.axis_sizes[a] > 1]

        def full(path, leaf):
            sh = _lookup(model.shardings, path)
            shape = [n * tp if sh is not None and s == "model" else n
                     for n, s in zip(leaf.shape, sh.spec if sh is not None
                                     else (None,) * leaf.dim())]
            return torch.empty(shape, device="meta")

        specs = rules.opt_state_shardings(
            {"m": tree_map_with_path(full, model.params)})["m"]
        self.dims: Dict[str, Optional[int]] = {
            path: (sh.spec.index("data") if self.size > 1
                   and "data" in sh.spec else None)
            for path, sh in tree_flatten_with_path(specs)}

    def part(self, tree):
        """This data rank's part of each leaf of a tree shaped like the
        rank-local parameters (a leaf whose moments stay whole is
        itself)."""
        def cut(path, leaf):
            d = self.dims.get(path)
            if leaf is None or d is None:
                return leaf
            n = leaf.shape[d] // self.size
            return leaf.narrow(d, self.rank * n, n)
        return tree_map_with_path(cut, tree)

    def reduce(self, loss, grads):
        """(loss summed over the data axes, each gradient's part of its
        sum over them)."""
        def total(t, groups):
            t = t.contiguous()
            for g in groups:
                t = collective("all_reduce", t, g)
            return t

        data = [self.mesh.get_group("data")] if self.size > 1 else []

        def cut(path, g):
            g = total(g, self.others)
            d = self.dims.get(path)
            if d is None:
                return total(g, data)
            return collective("reduce_scatter", g, data[0], dim=d)

        return (total(loss.clone(), self.others + data),
                tree_map_with_path(cut, grads))

    def gather(self, parts):
        """The updated parts gathered back to the rank-local leaves."""
        def join(path, leaf):
            d = self.dims.get(path)
            if leaf is None or d is None:
                return leaf
            return collective("all_gather", leaf.contiguous(),
                              self.mesh.get_group("data"), dim=d)
        return tree_map_with_path(join, parts)


def data_grad_sum(rules: ShardingRules):
    """``(loss, grads) -> (loss, grads)``: the loss and every gradient
    summed over the mesh's data axes (``data``, then ``pod``); nothing on
    one data rank."""
    groups = _data_groups(rules)

    def reduce(loss, grads):
        if not groups:
            return loss, grads

        def total(t):
            if not torch.is_tensor(t):
                return t
            t = t.contiguous()
            for g in groups:
                t = collective("all_reduce", t, g)
            return t

        from repro_torch._bridge import tree_map
        return total(loss.clone()), tree_map(total, grads)

    return reduce
