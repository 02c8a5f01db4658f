"""Shared finding model and the central rule registry of the sparsity
lint (port of ``repro.analysis.findings``).

Every analyzer — the recipe linter, the invariant verifier, the dispatch
auditor, the kernel auditor — reports through one structured
``Finding(severity, code, where, msg)`` so the CLI, a CI gate and the
tests consume a single surface.

Rule codes are STABLE identifiers shared with the reference: the same
codes, titles and severities.  ``RULES`` maps every code to a ``Rule``
(code, one-line title, doc paragraph); the docs of J201–J208 and
K300–K306 say what each rule means in this port (an eager dispatch
audit in place of an abstract trace, CUDA launches in place of Pallas
grids), so ``lint --explain CODE`` documents the port.  Emitting an
unregistered code is itself a bug (``Finding.__post_init__`` raises).

Severities:
  error   — the sparsity contract is broken: a silently-dense hot path,
            a plan inconsistent with its mask, a recipe that cannot
            run, a kernel launch that reads out of bounds.  The CLI
            exits nonzero on any error finding.
  warning — legal but almost certainly unintended (QAT before pruning,
            unreachable sparsity targets, f64 in a hot path).
  info    — measurements worth surfacing.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

SEVERITIES = ("error", "warning", "info")


@dataclass(frozen=True)
class Rule:
    """One registered rule: stable ``code``, one-line ``title`` (the
    README table row), and a ``doc`` paragraph (``lint --explain``)."""
    code: str
    title: str
    doc: str

    @property
    def family(self) -> str:
        return {"R": "recipe linter", "P": "invariant verifier",
                "J": "dispatch auditor", "K": "kernel auditor"}.get(
                    self.code[:1], "unknown")


_ALL_RULES: Tuple[Rule, ...] = (
    # recipe linter -------------------------------------------------------
    Rule("R001", "recipe/stage does not validate (construction failed)",
         "The recipe or one of its stages failed to construct at all — "
         "bad stage kind, malformed field, or a validation error raised "
         "by Recipe/Stage.  Nothing downstream can run until it builds."),
    Rule("R002", "prune granularity unknown to the target family",
         "A prune stage names a granularity the target family's "
         "strategy registry does not provide (e.g. 'expert' on a dense "
         "model).  The session would fail at stage entry."),
    Rule("R003", "non-monotonic target_sparsity: stage target already "
         "met by an earlier stage (dead stage)",
         "Stage targets must increase: a stage whose target_sparsity "
         "was already reached by an earlier stage commits no masks and "
         "silently does nothing."),
    Rule("R004", "non-positive retrain budget (0 silently falls back "
         "to the adapter default — it does NOT mean 'no retraining')",
         "retrain_steps <= 0 does not disable retraining; the adapter "
         "substitutes its own default budget.  Say what you mean with "
         "an explicit positive budget."),
    Rule("R005", "quantize stage before any prune stage (QAT "
         "calibrates a dense model)",
         "Quantization-aware calibration on the dense network is "
         "invalidated by the pruning that follows — the gate accepted "
         "ranges the pruned weights no longer have."),
    Rule("R006", "prune stage after a quantize stage (invalidates the "
         "QAT calibration the quantize gate accepted)",
         "Pruning after an accepted quantize stage changes the weight "
         "distribution the quantize gate validated; re-order or "
         "re-quantize."),
    Rule("R007", "target_sparsity unreachable within max_rounds at the "
         "stage rate",
         "Pruning fraction p per round reaches at most 1-(1-p)^rounds; "
         "a target beyond that leaves the stage spinning its full "
         "round budget and still failing its own exit condition."),
    Rule("R008", "duplicate stage names (resume + event attribution "
         "are keyed by stage identity)",
         "Mid-stage resume and PruneEvent attribution key on the stage "
         "name; duplicates make resume ambiguous."),
    Rule("R009", "recipe commits no masks (no prune stage)",
         "A recipe without any prune stage produces a dense ticket — "
         "legal, but the entire pipeline exists to prune; almost "
         "certainly a mistake."),
    # invariant verifier --------------------------------------------------
    Rule("P101", "TilePlan indices/counts malformed or out of bounds",
         "idx/counts array shapes must match the tile grid and every "
         "index must be a valid tile row — re-derived from the mask's "
         "tile bitmap."),
    Rule("P102", "TilePlan counts disagree with the mask's tile bitmap",
         "counts[j] must equal the number of live K tiles in column j "
         "of the independently recomputed bitmap."),
    Rule("P103", "TilePlan live-index set disagrees with the mask's "
         "tile bitmap",
         "The set of live indices idx[j, :counts[j]] must be exactly "
         "the bitmap's live rows for column j — no missing, no extra, "
         "no stale entries."),
    Rule("P104", "TilePlan kmax/nmax below the max live count",
         "The grid's last dimension is kmax/nmax; a cap below the "
         "true max live count silently drops tiles from the "
         "accumulation."),
    Rule("P105", "transposed plan (idx_t/counts_t) is not the exact "
         "transpose of the forward plan",
         "The dx backward runs off idx_t/counts_t; they must describe "
         "the same bitmap transposed, or forward and backward see "
         "different sparsity."),
    Rule("P106", "flat live-tile coords (kk/nn) disagree with the "
         "bitmap",
         "The dw kernel materialises exactly the tiles listed in "
         "kk/nn; they must be the bitmap's nonzero coordinates in "
         "row-major order."),
    Rule("P107", "live/total tile accounting disagrees with the bitmap",
         "live_tiles/total_tiles feed the perf model and reports; they "
         "must equal the bitmap's popcount and size."),
    Rule("P108", "geometry mismatch: mask shape vs tile/crossbar "
         "geometry",
         "A mask whose shape does not tile evenly at the configured "
         "crossbar geometry cannot be planned; the builder must have "
         "refused or fallen back explicitly."),
    Rule("P109", "decode plan disagrees with the mask's tile reduction "
         "(missing, extra, or stale plan entry)",
         "Per-projection decode plans are re-derived from the masks "
         "and compared entry-by-entry."),
    Rule("P110", "PlanStats totals disagree with the per-projection "
         "plans",
         "Aggregated live/total tile counts must equal the sum over "
         "the plan leaves they claim to summarise."),
    Rule("P111", "packing/XbarStats accounting disagrees with the mask",
         "Crossbar packing statistics (cells, xbars needed, savings) "
         "are recomputed from the raw mask and compared."),
    Rule("P112", "cross-generation inconsistency inside a ServeEngine",
         "After a hot-swap every generation must keep self-consistent "
         "params/masks/plans/caches; stale cross-links between "
         "generations corrupt in-flight decodes."),
    Rule("P113", "paged block table disagrees with the pool's "
         "ownership (unallocated, double-referenced, out-of-bounds, "
         "or off-scratch dead entry)",
         "Every live table entry must point at a block the pool "
         "assigned to that slot, and dead entries must point at the "
         "scratch block so the kernel's masked DMA stays in bounds."),
    Rule("P114", "paged cache gathered in logical block order does not "
         "reconstruct the dense oracle cache",
         "Adopting a dense prefill into the pool and gathering it back "
         "through the table must be bit-exact."),
    Rule("P115", "BlockPool accounting does not balance (free + live + "
         "scratch vs capacity, or reservations exceed free)",
         "The pool's free list, per-slot ownership, scratch block, and "
         "reservation counters must partition capacity exactly."),
    Rule("P116", "fleet accounting broken (a submitted uid finished "
         "zero or multiple times across engines, or merged report "
         "totals disagree with the per-engine sums)",
         "Failover must neither lose nor duplicate requests, and the "
         "merged fleet report must equal the sum of its engines."),
    # dispatch auditor ----------------------------------------------------
    Rule("J201", "dense dot_general on a weight shape a TilePlan "
         "covers (missed block-sparse routing)",
         "The audited closure runs once under a dispatch mode that records "
         "every aten op; outside the kernel wrappers' marked bodies, a "
         "dense aten.mm/addmm/bmm/baddbmm whose second operand's last two "
         "dims are a (K, N) shape only plan-covered weights have means "
         "the block-sparse routing was silently skipped (the port's "
         "counterpart of the reference's dense dot_general)."),
    Rule("J202", "float64 value in a hot-path trace (accidental x64 "
         "promotion)",
         "An op outside a kernel body produced a float64 tensor while "
         "the closure ran: a Python float or a numpy default dtype "
         "leaked into a step, doubling the bytes it moves on the card."),
    Rule("J203", "host callback inside a hot-path trace",
         "A host round trip inside the closure: aten._local_scalar_dense "
         "(.item(), int(t), bool(t)), an op whose output shape depends "
         "on the data (nonzero, masked_select, unique), or on CUDA a "
         "copy from the card to the host.  Each synchronises the "
         "stream with the host on every call."),
    Rule("J204", "hot-path closure is not jitted (per-call "
         "retrace/dispatch)",
         "The audited closure raised when it was run, so nothing of it "
         "could be audited.  The reference's second meaning, a closure "
         "that is not jitted, has no counterpart in an eager port and is "
         "never emitted."),
    Rule("J205", "plan covers projections but the traced closure "
         "issues no pallas_call at all (whole-path routing miss)",
         "A plan covers projections of this path, yet no kernel wrapper's "
         "marked body was entered while the closure ran: the whole path "
         "fell back to dense."),
    Rule("J206", "compiled artifact contains f64 tensors (HLO "
         "cross-check)",
         "Reads a compiled artifact, which the eager port does not have: "
         "never emitted.  `lint --hlo` exits 2 with a structured refusal "
         "until a counterpart of launch/hlo_analysis is ported."),
    Rule("J207", "collective traffic in a hot-path artifact (HLO "
         "cross-check)",
         "Reads a compiled artifact, which the eager port does not have: "
         "never emitted (see J206)."),
    Rule("J208", "sharded engine's jitted hot path traced on a "
         ">1-device mesh with replicated-only params (missing "
         "NamedSharding placement — GSPMD runs every device dense)",
         "Checks a mesh-backed engine's parameter placement: the port's "
         "counterpart of a NamedSharding is a LeafSharding, whose "
         "torch.distributed.tensor placements say which mesh axes cut "
         "each leaf.  An engine on a >1-rank mesh with no placed "
         "parameter leaf is an error (every rank holds and runs the whole "
         "model); one whose placements are all Replicate() is a warning "
         "(no dimension divided)."),
    # kernel auditor ------------------------------------------------------
    Rule("K300", "kernel spec malformed (grid/blocks inconsistent with "
         "declared shapes)",
         "The LaunchSpec of a CUDA launch is unusable: a non-positive "
         "grid, block or cluster extent, a cluster that does not divide "
         "the grid, block records that do not enumerate the grid exactly "
         "once, a rectangle or read outside the operand's rank, or an "
         "unknown meeting kind.  Remaining K-rules are skipped for that "
         "launch."),
    Rule("K301", "output-tile coverage not exact (skipped or "
         "multiply-written output tiles)",
         "Enumerating the blocks, every element of the output region is "
         "finally written exactly once: split pieces meet in a workspace "
         "(the last piece to finish writes the block, counted once) or in "
         "a thread-block cluster (each rank writes its own rows), and "
         "exactly one writer per element remains — none skipped on a "
         "ragged edge, none written twice, none written outside the "
         "region (dw's dead tiles stay the caller's zeros)."),
    Rule("K302", "input index map or block-table gather out of bounds",
         "Every read a block makes — plan-listed tiles, pool rows "
         "through the block table — lands inside its operand, and every "
         "block-table entry, live or dead, is a valid pool block (the "
         "engine parks dead entries on its scratch block)."),
    Rule("K303", "pl.when guard disagrees with the plan's liveness "
         "(dead blocks read, or live blocks masked off)",
         "For each output block, the tiles its blocks read over all "
         "split pieces equal the live set derived independently from the "
         "truth source: the mask's tile bitmap (not the plan), or the "
         "block lists and lengths a table was built from, or causal "
         "structure.  Extra reads stream dead tiles or rows past a "
         "length; missing ones drop live work."),
    Rule("K304", "accumulator/softmax scratch not float32, or scratch "
         "shape mismatched",
         "Accumulators, split partials and softmax running state are "
         "float32 (bf16 accumulation loses the exactness the plain "
         "versions are held to on the card)."),
    Rule("K305", "VMEM footprint estimate exceeds the backend budget",
         "A block's dynamic shared memory must fit the 232,448 bytes an "
         "H100 block may take (kernels.paged_attention._SMEM_LIMIT, the "
         "static_asserts of every .cu): a launch over it fails on the "
         "card.  The port's counterpart of the reference's VMEM budget."),
    Rule("K306", "kernel spec cost disagrees with the perf model's "
         "passes/FLOPs/bytes prediction",
         "The auditor enumerates passes (working blocks), flops and the "
         "bytes read and written at the route's block sizes from the "
         "LaunchSpec and compares them with core.perf_model's analytic "
         "H100 KernelCost from plan metadata and route rules, so the "
         "cost model and the launches cannot silently diverge."),
)

# The rule-code registry: tests assert every emitted code is registered
# and every code the port emits has a seeded-defect test.
RULES: Dict[str, Rule] = {r.code: r for r in _ALL_RULES}

#: the codes this port never emits, with the reason (their docs say so)
NEVER_EMITTED: Dict[str, str] = {
    "J206": "no compiled artifact in an eager port (lint --hlo exits 2)",
    "J207": "no compiled artifact in an eager port (lint --hlo exits 2)",
}


def rules_markdown() -> str:
    """The README rules table, generated from the registry."""
    lines = ["| Code | Checks |", "|------|--------|"]
    for r in _ALL_RULES:
        lines.append(f"| {r.code} | {r.title} |")
    return "\n".join(lines)


def explain(code: str) -> str:
    """Human-readable account of one rule (``lint --explain CODE``)."""
    rule = RULES.get(code.upper())
    if rule is None:
        known = ", ".join(sorted(RULES))
        raise KeyError(f"unknown rule code {code!r}; known: {known}")
    return f"{rule.code} [{rule.family}]\n  {rule.title}\n\n{rule.doc}"


@dataclass(frozen=True)
class Finding:
    """One lint result: ``severity`` ∈ {error, warning, info}, ``code``
    a stable rule id from ``RULES``, ``where`` a location path (e.g.
    ``vgg11/recipe:cnn-full/stage[2]:prune:index`` or
    ``llama3.2-3b/decode/seg0.0.mlp.up``), ``msg`` the human account."""
    severity: str
    code: str
    where: str
    msg: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}; "
                             f"known: {SEVERITIES}")
        if self.code not in RULES:
            raise ValueError(f"unregistered rule code {self.code!r} — "
                             f"add it to analysis.findings.RULES")

    def to_dict(self) -> dict:
        return {"severity": self.severity, "code": self.code,
                "where": self.where, "msg": self.msg}

    def __str__(self) -> str:
        return f"[{self.severity.upper():7s}] {self.code} {self.where}: " \
               f"{self.msg}"


def error(code: str, where: str, msg: str) -> Finding:
    return Finding("error", code, where, msg)


def warning(code: str, where: str, msg: str) -> Finding:
    return Finding("warning", code, where, msg)


def info(code: str, where: str, msg: str) -> Finding:
    return Finding("info", code, where, msg)


@dataclass
class Report:
    """An ordered collection of findings with severity accounting."""
    findings: List[Finding] = field(default_factory=list)

    def add(self, f: Finding) -> None:
        self.findings.append(f)

    def extend(self, fs: Iterable[Finding]) -> None:
        self.findings.extend(fs)

    @property
    def errors(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == "error")

    @property
    def warnings(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == "warning")

    @property
    def ok(self) -> bool:
        """True when no error-severity finding was recorded."""
        return not self.errors

    def codes(self) -> Tuple[str, ...]:
        return tuple(f.code for f in self.findings)

    def by_code(self, code: str) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.code == code)

    def summary(self) -> dict:
        counts = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            counts[f.severity] += 1
        return {"findings": len(self.findings), **counts, "ok": self.ok}

    def to_dict(self) -> dict:
        return {"findings": [f.to_dict() for f in self.findings],
                "summary": self.summary()}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)
