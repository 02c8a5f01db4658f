"""Global model hooks a mesh installs (a port of ``repro.models.hooks``).

``distributed.sharding.install`` sets the MoE dispatch groups; outside a
mesh there is one group.  The reference's ``constrain`` /
``set_constrain_fn`` pair is not ported: it annotates a global array
with ``with_sharding_constraint``, while the port runs rank-local, each
activation already this rank's own rows and columns.

The port also keeps the active tensor-parallel context here
(``distributed.tensor_parallel.TensorParallel``, None outside a mesh
with a model axis > 1): the projections, the embedding, the unembedding
and the MoE experts read it to run rank-local on their shards.  A
train step on a data axis > 1 installs ``moe_aux_sum``: the MoE layers
sum their aux loss's token statistics over the data ranks with it, so
that the loss stays global over the batch.
"""
from __future__ import annotations

_MOE_GROUPS = 1
_TENSOR_PARALLEL = None
_MOE_AUX_SUM = None


def set_moe_groups(g: int):
    """Dispatch groups for MoE (= data-parallel shard count).

    Grouped dispatch keeps the sort/scatter/gather of the capacity
    buffer local to each data shard (GShard/Switch 'groups')."""
    global _MOE_GROUPS
    _MOE_GROUPS = max(1, int(g))


def moe_groups() -> int:
    return _MOE_GROUPS


def set_tensor_parallel(tp):
    """Install (or, with None, remove) the tensor-parallel context."""
    global _TENSOR_PARALLEL
    _TENSOR_PARALLEL = tp


def tensor_parallel():
    return _TENSOR_PARALLEL


def set_moe_aux_sum(fn):
    """Install (or, with None, remove) the data-axis sum of the MoE aux
    loss's statistics: ``fn(t) -> t`` summed over every data rank."""
    global _MOE_AUX_SUM
    _MOE_AUX_SUM = fn


def moe_aux_sum():
    return _MOE_AUX_SUM
