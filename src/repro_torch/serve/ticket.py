"""Pruned-ticket → serving-kernel handoff (re-export shim; port of
``repro.serve.ticket``).

The mask→``TilePlan`` walker lives in ``repro_torch.models.plans``: it
describes the model's parameter structure (segments → positions →
attn/mlp projections) and is shared by the serving paths (ONE plan
drives both prefill and decode in ``ServeEngine``) and the retrain path
(``repro_torch.train.plans``), so neither layer imports the other.
"""
from repro_torch.kernels.bsmm import GeometryError  # noqa: F401
from repro_torch.models.plans import (PlanStats,  # noqa: F401
                                      build_decode_plan)
