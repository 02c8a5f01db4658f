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
    rank runs its experts' rows, then the outputs are gathered.

A block the rank-local model cannot run on a shard stays whole on every
model rank ("kept whole against its spec", listed by ``layout``): an
MLP whose ``d_ff`` does not divide (the rules' fallback splits its
input dim), and any block with a block-sparse projection whose shard
would split a 128-tile — ``plan_matmul`` needs its plan to cover the
weight, so that projection runs on the full weight with the full plan,
which is what GSPMD does to the reference's Pallas custom call.
Attention shards as two groups: q (``wq``/``wo``, Hq/M heads a rank)
and K/V (``wk``/``wv``).  When the K/V heads do not divide (or their
shard would cut a tile) K/V stay whole on every model rank with their
caches, and each rank attends its local q heads against the kv heads
they map to (its q heads placed among zero heads, the other heads'
outputs dropped); when the q heads do not divide, the whole attention
stays whole.  Nothing drops to dense: each rank's plans are built from
its own mask shard, which is exact because pruned weights are exact
zeros.

Collectives go through ``collective``: the one place where a gloo group
(two ranks sharing a card) stages CUDA tensors through host memory, and
where a ``launch.hlo_analysis.StepTrace`` records them on fake tensors.

Training on a mesh uses Megatron's conjugate operators
(``torch.autograd.Function``s over ``collective``), entered only while
autograd records, so that serving runs the collectives alone:

  * copy-to-model (``TensorParallel.copy_in``): identity forward,
    ``all_reduce`` backward — on the input of each column-parallel group
    (q and sharded K/V, the MLP's up/gate, the unembedding, the experts'
    rows), on a replicated bias cut to local columns, and on K/V kept
    whole (each rank's heads read all of them);
  * reduce-from-model: ``all_reduce`` forward, identity backward — the
    row-parallel output and the vocab-parallel lookup;
  * gather-from-model: ``all_gather`` forward, this rank's slice
    backward — the unembedding's logits and the experts' outputs.

So every replicated leaf gets the same gradient on every model rank.
``train_loss`` is the global token mean (each data rank's token-loss
sum over the global token count) and ``data_grad_sum`` sums the
gradients over the data axes before the optimizer, so that unequal loss
masks still give the single-device gradient.  ZeRO-1 (``Zero1``) cuts
the optimizer state over ``data`` instead: each gradient is
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

from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MXU_TILE,
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
            bias=None if bias is None else self.cols(self.copy_in(bias)),
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
def _supports_model_axis(cfg: ArchConfig) -> None:
    if cfg.mla is not None:
        what = "MLA attention"
    elif not set(cfg.blocks) <= {ATTN, LOCAL_ATTN}:
        what = "recurrent blocks"
    elif cfg.is_encoder_decoder:
        what = "the encoder-decoder"
    else:
        return
    raise NotImplementedError(
        f"{cfg.name}: {what} on a model axis > 1 is not yet ported to "
        "repro_torch (a (D, 1) mesh serves it)")


def _tiles(shape, tile: int = MXU_TILE) -> bool:
    return shape[-1] % tile == 0 and shape[-2] % tile == 0


# the tensor dim each block's leaves shard on the model axis; a leaf of
# a block runs sharded only when its spec puts "model" there and nowhere
# else (the rules' fallbacks to another dim are kept whole)
_SHARD_DIM = {"attn": {"wq": -1, "wk": -1, "wv": -1, "wo": -2},
              "mlp": {"up": -1, "gate": -1, "down": -2},
              "experts": {"up": -3, "gate": -3, "down": -3},
              "table": {"table": -2}}


def _block_of(path: str):
    """(block key, kind) of a leaf that shards with a block, else None."""
    parent, _, name = path.rpartition("/")
    kind = parent.rpartition("/")[2]
    if kind == "moe" and name in _SHARD_DIM["experts"]:
        return parent, "experts"
    if kind == "attn" and name in _SHARD_DIM["attn"]:
        return parent + ("/q" if name in ("wq", "wo") else "/kv"), "attn"
    if name in _SHARD_DIM["mlp"]:
        return parent, "mlp"
    if name == "table":
        return path, "table"
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
    if m > 1:
        _supports_model_axis(cfg)
    masked = set()
    if masks is not None:
        tree_map_with_path(lambda p, l: l is not None and masked.add(p),
                           masks)
    specs: Dict[str, tuple] = {}
    ok: Dict[str, bool] = {}        # block key -> runs sharded

    def visit(path, leaf):
        if leaf is None:
            return
        shape = tuple(leaf.shape)
        spec = specs[path] = rules.param_spec(path, shape)
        blk = _block_of(path)
        if blk is None:
            return
        key, kind = blk
        dim = len(shape) + _SHARD_DIM[kind][path.rpartition("/")[2]]
        good = spec[dim] == "model" and spec.count("model") == 1
        if good and kind in ("attn", "mlp") and path in masked \
                and _tiles(shape):
            # a block-sparse projection whose shard would cut a 128-tile
            local = tuple(n // m if e == "model" else n
                          for n, e in zip(shape, spec))
            good = _tiles(local)
        ok[key] = ok.get(key, True) and good

    tree_map_with_path(visit, params)
    # one q and one kv head count for every attention layer; K/V shard
    # only with the q heads
    q_ok = all(v for k, v in ok.items() if k.endswith("/attn/q"))
    kv_ok = q_ok and all(v for k, v in ok.items() if k.endswith("/attn/kv"))
    for k in ok:
        if k.endswith("/attn/q"):
            ok[k] = q_ok
        elif k.endswith("/attn/kv"):
            ok[k] = kv_ok
    whole: List[Tuple[str, tuple]] = []

    def mk(path, leaf):
        if leaf is None:
            return None
        spec = specs[path]
        blk = _block_of(path)
        if m > 1 and "model" in spec and not (blk and ok[blk[0]]):
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
    """The local leaves whose placement shards them over ``model``; a
    leaf sharded where the rank-local model cannot run it raises."""
    out: List[torch.Tensor] = []

    def visit(path, leaf):
        sh = _lookup(shardings, path)
        if leaf is None or sh is None or "model" not in sh.spec:
            return leaf
        blk = _block_of(path)
        dim = blk and len(sh.spec) + _SHARD_DIM[blk[1]][
            path.rpartition("/")[2]]
        if not blk or sh.spec[dim] != "model":
            raise ValueError(f"{path}: a {sh.spec} shard does not run "
                             "rank-local; keep it whole (layout)")
        out.append(leaf)
        return leaf

    tree_map_with_path(visit, local)
    return out


def _heads_sharded(shardings, leaf: str) -> bool:
    """True when every attention layer's ``leaf`` (``wq`` or ``wk``)
    is placed as a shard of its heads."""
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
    explicit)."""
    if model == 1 or not _heads_sharded(shardings, "wq"):
        return cfg
    kv = _heads_sharded(shardings, "wk")
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // model,
        n_kv_heads=cfg.n_kv_heads // model if kv else cfg.n_kv_heads,
        head_dim=cfg.head_dim_)


@contextlib.contextmanager
def scope(rules: Optional[ShardingRules], tp: Optional[TensorParallel],
          groups: Optional[int] = None):
    """Install ``rules`` (MoE groups — or ``groups`` in their place) and ``tp`` for the duration of a call;
    whatever was installed before comes back afterwards."""
    from repro_torch.distributed import sharding
    prev_rules, prev_tp = sharding.installed(), hooks.tensor_parallel()
    prev_groups = hooks.moe_groups()
    sharding.install(rules)
    if groups is not None:
        hooks.set_moe_groups(groups)
    hooks.set_tensor_parallel(tp)
    try:
        yield
    finally:
        sharding.install(prev_rules)
        hooks.set_moe_groups(prev_groups)
        hooks.set_tensor_parallel(prev_tp)


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


def data_rows(batch, rules: ShardingRules):
    """This rank's rows of a global batch (numpy or tensor leaves), as
    ``batch_spec`` places them over the data axes."""
    def cut(_, leaf):
        sh = rules.leaf_sharding(rules.batch_spec(tuple(leaf.shape)))
        return place(torch.as_tensor(leaf), sh)
    return tree_map_with_path(cut, batch)


def sharded_loss(model: ShardedModel, batch) -> float:
    """The mean next-token cross-entropy of a global ``batch`` on a mesh
    (forward only): each data rank runs its rows through the
    tensor-parallel model, and the token-loss sums and counts are summed
    over the data axis.  Dense-FFN models (an MoE aux loss is global
    over the batch, which this sum does not form)."""
    from repro_torch.models import transformer as tfm
    if model.cfg.moe is not None:
        raise NotImplementedError("sharded_loss: MoE aux loss on a mesh")
    rows = data_rows(batch, model.rules)
    dev = model.params["embed"]["table"].device
    rows = {k: v.to(dev) for k, v in rows.items()}
    with torch.no_grad(), model.scope():
        logits, _ = tfm.forward(model.params, model.cfg, rows)
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, rows["labels"].long()[..., None])[..., 0]
        mask = rows.get("loss_mask")
        mask = (torch.ones_like(lse) if mask is None else mask.float())
        tot = torch.stack([((lse - ll) * mask).sum(), mask.sum()]).double()
    if model.rules.dp_size > 1:
        collective("all_reduce", tot, model.rules.mesh.get_group("data"))
    return float(tot[0] / tot[1].clamp_min(1.0))


# ---------------------------------------------------------------------------
# Training on a mesh
# ---------------------------------------------------------------------------
def _data_groups(rules: ShardingRules) -> list:
    return [rules.mesh.get_group(a) for a in rules.dp_axes
            if rules.axis_sizes[a] > 1]


def check_trainable(cfg: ArchConfig, rules: ShardingRules) -> None:
    """Raise ``NotImplementedError`` naming the family when ``cfg``
    cannot train on ``rules``' mesh: MLA, the recurrent blocks and the
    encoder-decoder on a model axis > 1, the MoE aux loss (global over
    the batch) and the encoder-decoder's loss on a data axis > 1.
    Nothing is drawn first: a launcher calls it before its
    parameters."""
    if rules.tp_size > 1:
        _supports_model_axis(cfg)
    if _data_groups(rules) and cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the MoE aux loss on a data axis > 1 is not yet "
            "ported to repro_torch (it is global over the batch)")
    if _data_groups(rules) and cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder's loss on a data axis > 1 is "
            "not yet ported to repro_torch")


def train_loss(model: ShardedModel, *, plan=None, aux_weight: float = 0.01):
    """``(params, batch) -> (loss, metrics)`` of this rank's rows on
    ``model``'s mesh, the forward under the model's scope (one MoE
    dispatch group: a rank's rows are its data shard's).  The train
    step must enter ``train_scope(model)`` around the backward too:
    remat recomputes each layer there, under the same scope.  On one data
    rank it is the model's own ``loss_fn``; over a data axis the global
    token mean: the same ``loss_fn`` with the token count summed over the
    data axes as its denominator (``softmax_cross_entropy``'s ``count``;
    ``data_grad_sum`` then sums the losses and the gradients)."""
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tfm
    cfg, rules = model.cfg, model.rules
    check_trainable(cfg, rules)
    groups = _data_groups(rules)
    mod = encdec if cfg.is_encoder_decoder else tfm

    def loss(p, batch):
        kw = {} if cfg.is_encoder_decoder else {"aux_weight": aux_weight,
                                                "plan": plan}
        if groups:
            mask = batch.get("loss_mask")
            labels = batch["labels"]
            count = (torch.full((), float(labels.numel()),
                                device=labels.device) if mask is None
                     else mask.float().sum().detach().clone())
            for g in groups:
                count = collective("all_reduce", count, g)
            kw["count"] = count
        with model.scope(groups=1):
            return mod.loss_fn(p, cfg, batch, **kw)

    return loss


def train_scope(model: ShardedModel):
    """``params -> context`` that a mesh's train step enters around its
    forward and backward (``make_train_step(scope=)``): the model's scope
    with the step's own parameters bound as the shards."""
    def enter(params):
        if model.tp is not None:
            model.tp.bind(sharded_leaves(params, model.shardings))
        return model.scope(groups=1)
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
