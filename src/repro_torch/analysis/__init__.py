"""Sparsity lint for the port: static verification of recipes, tile
plans, serving state and CUDA launch geometry (port of
``repro.analysis``).

Four analyzers, one structured ``Finding`` model with the reference's
stable rule codes (``findings.RULES``):

* ``recipe_lint``    — R001–R009, recipe programs vs family
  capabilities;
* ``invariants``     — P101–P116, tile plans / decode plans / crossbar
  stats / paged-KV pools / engine generations / fleet accounting
  re-derived from their sources and compared;
* ``dispatch_audit`` — J201–J205, the hot paths run once under a
  dispatch mode that records every aten op (dense routing misses, f64
  values, host round trips; kernel bodies opaque) — the counterpart of
  the reference's ``jaxpr_audit``;
* ``kernel_audit``   — K300–K306, each CUDA launch's ``LaunchSpec``
  (``kernels.spec``) enumerated block by block: final-writer coverage,
  read bounds, liveness against the truth source, f32 accumulators,
  the H100's shared memory, the H100 cost model.

``lint.lint_arch`` runs the first three against a registered arch and
``lint.lint_kernels`` the fourth; the CLI surface is ``python -m
repro_torch.api lint [--arch NAME | --all] [--kernels] [--device cpu]``
with ``--explain CODE`` documenting any rule.
"""
from repro_torch.analysis.findings import (NEVER_EMITTED, RULES, SEVERITIES,
                                           Finding, Report, error, explain,
                                           info, rules_markdown, warning)
from repro_torch.analysis.kernel_audit import (AuditCase, audit_case,
                                               audit_kernel_spec,
                                               audit_kernels, default_cases)
from repro_torch.analysis.invariants import (verify_block_pool,
                                             verify_block_tables,
                                             verify_decode_plan,
                                             verify_engine,
                                             verify_mask_accounting,
                                             verify_paged_engine,
                                             verify_paged_reconstruction,
                                             verify_tile_plan, verify_fleet,
                                             verify_xbar_stats)
from repro_torch.analysis.dispatch_audit import (audit_closure,
                                                 audit_engine_sharding,
                                                 collect_covered,
                                                 unambiguous_covered)
from repro_torch.analysis.lint import lint_all, lint_arch, lint_kernels
from repro_torch.analysis.recipe_lint import (lint_recipe,
                                              lint_recipe_for_family)

__all__ = [
    "RULES", "SEVERITIES", "NEVER_EMITTED", "Finding", "Report", "error",
    "warning", "info", "explain", "rules_markdown",
    "AuditCase", "audit_case", "audit_kernel_spec", "audit_kernels",
    "default_cases",
    "lint_recipe", "lint_recipe_for_family",
    "verify_tile_plan", "verify_decode_plan", "verify_xbar_stats",
    "verify_mask_accounting", "verify_engine", "verify_block_pool",
    "verify_block_tables", "verify_paged_engine",
    "verify_paged_reconstruction", "verify_fleet",
    "audit_closure", "audit_engine_sharding",
    "collect_covered", "unambiguous_covered",
    "lint_arch", "lint_all", "lint_kernels",
]
