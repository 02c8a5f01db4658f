#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero and prints
no result line otherwise):

1. print the card's name and power limit (``nvidia-smi``) and build the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, started together);
2. check every kernel against its plain PyTorch version on the card, at
   the shapes serving and retraining llama3.2-3b give it (forward bsmm
   and its epilogue, paged attention, the backward dx and dw with a
   ragged row count) and serving deepseek-v3 gives it (the fused-V
   paged attention of absorbed MLA, and bsmm batched over 256 experts),
   in bfloat16 and float32, with the tolerance printed, and time
   kernel, plain version and a library yardstick; flash attention at
   llama3.2-3b's prefill shapes (S 128, 300, 512, 1024, 4096, and the
   PREFILL_32K cell's 32767 and 32768; full and float32 at 512) and
   deepseek-v3's MLA prefill (hd 192, dv 128), each
   dtype on its own route (bfloat16: the wgmma kernel, float32: the
   CUDA-core one), every bfloat16 shape faster than its plain version
   and closer to SDPA than the CUDA-core kernel was, where that was
   timed; recurrentgemma-2b's local attention (S 300 and 2048, 10
   query heads over one KV head, hd = dv = 256, the wgmma kernel's
   ``<4,4,64>`` instantiation; float32 at 300); phi-3-vision's
   prompt (32 heads of 96, bf16 and f32), whisper-tiny's encoder (1500
   frames, full) and a decoder prompt (6 heads of 64); paged attention
   #6 at phi-3's decode (32 query and KV heads of 96); #1/#2 at
   recurrentgemma-2b's and command-r-35b's projections at 8 and 1024
   rows (the gate's gelu and silu epilogues) and #3/#4 at
   recurrentgemma's at 1000 and 1024; #1/#2 at llama4-maverick's
   projections (5120 wide) at 8, 129 and 300 rows and #1b over its 64
   experts (5120 <-> 8192) at every expert capacity its serving passes
   give; #1-#4 at phi-3-vision's retrain rows (8192); and
   print the wgmma kernel's registers, spills (``-Xptxas=-v``) and
   shared memory;
3. serve 8 requests through ``ServeEngine`` at the full width and depth
   of llama3.2-3b (28 layers, random weights from a seeded generator)
   with a crossbar-pruned ticket (one seeded 128x128 tile bitmap per
   projection, ~25 % live, shared by all layers), and check that every
   request finishes, that every kernel was launched on that path (every
   prefill's flash attention on the wgmma route), that every logit is
   finite, and that block-sparse prefill through the ticket's plan
   agrees with dense prefill on the masked weights; then profile one
   decode-only tick of 8 busy slots (device time by kernel group);
2b. the crossbar-unaware LTP baseline of llama3.2-3b's MLP at full width
   (up and gate 3072 x 8192, down 8192 x 3072, bf16, seeded weights
   pruned to the largest 10 % of |w| by the ``ltp`` criterion), every
   product through kernel #5, at decode rows (8) and prefill rows
   (1024): with #5's counts set to 0 before and read after, the decode
   products on its ``stream`` kernel and the prefill products on its
   ``wgmma`` kernel, the output held to the same MLP through the plain
   version, and timed beside ``torch.matmul`` on the masked weights;
3b. the serving control plane at the same width cut to 8 of its 28
   layers (``CP_LAYERS``; the script's time): two crossbar tickets
   (seeded bitmaps) exported through ``core.lottery`` and registered in
   a ``TicketManager`` (fingerprints through ``smoke_decode``), a
   ``FleetRouter`` of two engines fleet-swapped from ticket A to B
   mid-stream (in-flight streams held to a no-swap run, later
   admissions on B's generation), the same swap again at temperature
   0.8 (in-flight sampled streams held to a sampled no-swap run, each
   with at least 2 distinct tokens), one heartbeat failover of engine 0
   on an injected clock (every uid done, moved greedy streams held to
   the never-failed run, token by token and in their logits at the
   bf16 gate, their distinct tokens printed), a dense-slot
   (``paged=False``) engine against the paged one, flash attention
   launched once per layer and prefill, all on the wgmma route, one
   profiled prefill, and ``api.cli serve --engines 2`` at full width
   and depth;
4. check one loss backward through the ticket's plan against dense
   autograd at full width and 2 layers;
5. retrain the full-width, full-depth ticket for 4 steps through
   ``LMAdapter.make_trainer(params, masks).run`` and check losses,
   parameters, pruned coordinates, ``sent_fraction`` and the launches
   of every kernel per step (dx and dw all on their ``wgmma`` kernels);
   then profile one more step, which must show dx kernel time;
5b. run an LM pruning program through the entry points a user calls:
   ``make_adapter`` on llama3.2-3b at its published widths with one
   cut, 28 layers to 4 (the host-side prune scores every prunable
   weight a round), and ``PruningSession(...).run()`` on the
   ``dense-full`` recipe cut to one round of 4 retrain steps a prune
   stage, printing every event with its wall time; its int8 quantize
   stage must run and be accepted.  On the ticket: 4 plain and 4 int8
   QAT retrain steps (step time, peak memory; the QAT steps' bsmm
   launches, routes and split launches held to the model), the fake
   pass checked on the card (masked weights 0, live ones within
   scale/2 and one bf16 ulp), the int8 tree's bytes beside the dense
   tree's and the hardware report's, ``pack_lm_params`` (the packed
   model's dense logits against the pruned model's block-sparse ones,
   or no change when no column packs away), the ticket's export, and
   ``api.cli finetune`` (QAT) and ``api.cli report`` on it in process;
   the 2-D bsmm counts are set to 0 before this phase and read after;
6. free the llama models and serve 8 requests through ``ServeEngine`` on
   deepseek-v3 at full width with its one cut, 61 layers to 4 (three
   dense, one MoE layer of 256 experts, top-8, one shared expert; MLA
   attention; ~30 GB of bf16 parameters), with a ticket of one seeded
   tile bitmap per projection shared by every layer and expert, and
   check that every request finishes with finite logits, that the
   fused-V kernel ran once per layer and decode step, every launch on
   its ``wgmma`` kernel (the GQA kernel never), that the bsmm, epilogue
   and batched launches match the model (every batched forward on its
   ``stream`` kernel, none split), that flash attention ran once per
   layer and prefill on the wgmma route, and that block-sparse prefill
   agrees with dense prefill;
6b. free the serving model and retrain deepseek-v3 at full width with
   two cuts, 61 layers to 2 (one dense, one MoE layer) and 256 routed
   experts to 32 (4.10 G parameters, the most that fit the card with
   bf16 grads and f32 AdamW moments): first the MoE layer alone, its
   gradients through the ticket's plans against dense autograd on the
   masked weights (x, router, experts, shared expert; 5e-2 of each
   scale), then ``make_adapter(cfg).make_trainer(params, masks).run(1)``
   four times, checking losses, the aux loss (finite, > 0), parameters,
   pruned coordinates, ``sent_fraction``, and every bsmm kernel's
   launches, routes and split launches per step (the experts' forward,
   dx and dw batched, one launch each per projection, all on their
   ``wgmma`` kernels); then one profiled step, which must show the
   batched forward, dx and dw, and the peak memory beside its
   reckoning; then, the plain trainer freed, 4 int8 QAT steps of
   ``make_trainer(params, masks, quantize_bits=8)`` on the same cut,
   timed, their peak printed and their launches held as the plain
   steps' are;
6c. serve 8 requests through ``ServeEngine`` on recurrentgemma-2b at
   its published width and depth (26 layers: 18 RG-LRU, 8 local
   attention with window 2048; 2.66 G parameters) with a seeded ~25 %
   ticket on every planned projection, on dense slots at capacity 4224:
   seven prompts of 5-300 tokens and one of 4096 (two windows: the
   two-chunk prefill and the ring's wrap), 32 new tokens each; check
   finishing, finite logits, flash attention once per local layer and
   prompt within a window (all on the wgmma route at hd = dv = 256;
   never for the 4096-token prompt), #1/#2's launches, routes and split
   launches held to the model, plan-vs-dense prefill, and the engine's
   logits (``ServeEngine.logits_sink``) of the 4096- and 129-token
   requests against a teacher-forced ``forward`` on the masked weights,
   within 5e-2 of each row's max |logit|; profile one decode tick;
6d. retrain that ticket 4 steps through ``make_adapter(
   "recurrentgemma-2b", scale="full").make_trainer(params,
   masks).run(1)`` at 8 x 128 tokens: finite losses and parameters,
   pruned coordinates zero, #1-#4's launches, routes and split launches
   per step held to the model; the median step, the peak memory and
   one profiled step;
6e. serve 8 requests of 5-300 prompt and 16 new tokens on command-r-35b
   (LayerNorm) at its published widths with one cut, 40 layers to 8
   (7.73 G parameters), paged, with the llama serving phase's checks
   (#8 once a layer and prefill, #6 once a layer and decode step);
6f. the last four families, each with a seeded ~25 % ticket
   (``build_planned_ticket`` on planned projections,
   ``build_expert_ticket`` on experts, ``family_ticket`` from the
   family's predicate where nothing is planned), each phase's model
   freed before the next; each serving phase is ``serve`` (the llama
   phase's skeleton and checks: every launch, route and split count
   the model implies, #8's calls by length and causality) with the
   family's ticket and reference: ``serve_xlstm`` (xlstm-125m at full
   width and depth, 8 requests of 5-300 tokens, one of exactly 256, on
   dense slots: no kernel launched, every request's logits held to a
   teacher-forced ``forward``) and ``retrain_xlstm`` (4 steps of 8 x
   128 tokens); ``serve_whisper`` (whisper-tiny through the engine's
   frames lane, 8 requests with ``serve_frames`` and prompts of 4-64
   tokens: #8 4 times full at S = 1500 and 4 times causal a request,
   all ``wgmma``, the logits to a teacher-forced ``encdec.forward``;
   then ``api.cli serve --arch whisper-tiny --scale full`` in process)
   and ``retrain_whisper`` (``EncDecAdapter.train``, 8 x 128 tokens
   over 1500 frames, every step's loss finite); ``serve_vlm``
   (phi-3-vision at full width and depth, text-only prompts, paged: #6
   and #8 at head width 96, plan-vs-dense prefill, the logits to a
   teacher-forced ``forward``) and ``retrain_vlm`` (cut to 8 layers,
   576 patches + 448 tokens a row through #1-#4); ``serve_llama4``
   (llama4-maverick cut to 4 layers and 64 experts, dense slots: #1/#2
   and #1b on their routes, each prefill row held to ``forward``
   without a plan, the top-1 experts of both compared);
6g. distribution (``distributed_phase``; every count set to 0 before a
   leg's run and read after it): (a) llama3.2-3b at full width and
   depth, 8 requests x 16 tokens, on a (1, 1) mesh over NCCL against the
   meshless engine on the same tree and ticket: streams and logits
   bitwise equal, every kernel's launches by route and split equal, the
   decode ticks beside each other; (b) two ranks sharing the card over
   gloo (``launch.mesh.run_ranks``), llama3.2-3b at full width cut to 4
   layers on (1, 2) and (2, 1) meshes: each rank's #1/#2 on its local
   plans (on (1, 2): wq 1536, wk/wv 512, up/gate 4096 columns, wo 1536
   and down 4096 rows), #8 and #6 at its local heads (12 and 4 on
   (1, 2)), every kernel launched, each row's logits within 5e-2 of its
   max |logit| of the rank's own single-rank engine, greedy divergences
   counted, and every (rows, weight) shape of #1/#2, (S, heads) of #8
   and head count of #6 that either rank launched then held to the
   plain versions in the main process (bf16 and f32, usual
   tolerances, routes and splits; timed at 8 decode rows); (c) grouped MoE dispatch at deepseek-v3's expert widths
   (7168 <-> 2048, top-8) over its 256 experts, G = 1, 2, 4: one #1b
   launch a projection, held to the same dispatch through #1b's plain
   version, ``drop_fraction`` equal to the capacity formula's; (d)
   llama4-maverick's MoE block (64 experts, 5120 <-> 8192, top-1) on
   the two ranks, 32 experts each through #1b, the outputs gathered
   and held to the one-rank block; (e) ``Supervisor`` around a
   2-layer full-width llama3.2-3b retrain whose third step fails once:
   it resumes from step 2's checkpoint and reaches its 4 steps; (f)
   training on a tensor-parallel mesh: llama3.2-3b at full width cut to
   4 layers under its ticket, 2 masked AdamW steps (lr 1e-3) through
   #1-#4 on the local plans, on the two gloo ranks at (1, 2) and (2, 1)
   against the meshless trainer on the same rank: each step's loss
   within 1e-3 (relative), each step's gradient as the optimizer
   receives it within 3e-2 of the meshless leaf's norm, the first
   update within lr / 4 wherever the meshless one moved a coordinate
   whose gradients share a sign, the meshless one at least the RMS of
   its leaf's nonzero entries, and whose bf16 spacing is at most lr / 8
   (``TP_*``); every (M, K, N) of #1-#4 that the ranks
   launched then held to the plain versions in the main process; and
   on leg (a)'s (1, 1) NCCL mesh the trainer bitwise the meshless one
   (losses, gradients, parameters), launch for launch; (g) the last
   families on a mesh (``families_leg``, its own phase
   ``distributed_g``): deepseek-v3's meshless engine here (4 layers,
   256 experts), then two gloo ranks sharing the card, every count set
   to 0 before and read after: recurrentgemma-2b at full width and
   depth served on (1, 2) (5 q heads against K/V kept whole, the RG-LRU
   channel-parallel) and (2, 1) with a 4096-token prompt past its
   window, xlstm-125m (float32) and whisper-tiny (frames lane) on
   (1, 2), deepseek-v3 on (1, 2) (MLA at 64 heads: #7 on ``wgmma``;
   each rank drawing and cutting its tree in turn), each engine's rows
   within 5e-2 of the meshless engine's, its local heads and kept-whole
   leaves the designed ones; then 2 AdamW steps of recurrentgemma (4
   layers), xlstm, whisper (both meshes), deepseek (1 MoE layer, 16
   experts) and llama4 (2 layers, 4 experts, on (2, 1): the MoE aux
   loss on a data axis) against the meshless trainer run on rank 0
   alone, by leg (f)'s ``check_train_leg`` (the trainers in float32
   but whisper's, the big ones' vocabularies cut to 32768 rows, every
   other leaf held, deepseek's routed experts through host memory;
   llama4's norms, router and shared expert), and recurrentgemma's again
   in bf16 on (1, 2), each leaf's gradient held to float32 within twice
   the meshless bf16 trainer's own distance (``fam_bf16_witness``);
   every kernel of the leg (#1-#4, #1b, #3b, #4b, #7, #8) launched, then
   held to its plain version at every shape and dtype either rank gave
   it;
6h. the entry points a user starts the port with (``launch_phase``;
   every count set to 0 before a leg and read after it): (a)
   ``launch.serve.main`` on llama3.2-3b at full width cut to 8 layers
   (registered as ``llama3.2-3b-8l``: its host prune's time), pruned
   75 % in the launcher's three crossbar-aware steps, 16 requests x 16
   tokens on a (1, 1) mesh: every request done, every logit finite, the
   engine's plan the ticket's 128x128 tile union, #1/#2 by route and
   split, #6 (once a layer and decode step) and #8 (once a layer and
   prefill, each call's length, all ``wgmma``) what the plan and the
   engine's passes give; (b) the same launcher, dense, ``--engines 2
   --heartbeat-dir``: #6 and #8 only, no failover; (c)
   ``launch.train.main`` at full width and depth, 4 steps of 8 x 128
   tokens (dense, plain attention: no kernel), each step timed, losses
   finite, ``done at step 4``, the peak memory; (d) ``launch.steps``
   cells on llama3.2-3b at full width and depth, each cut to one
   sequence: TRAIN_4K (two steps; the meta specs drive the inputs and
   match the real trees), PREFILL_32K fed 32767 tokens and then
   DECODE_32K on its caches (their shapes ``cache_specs``') with token
   32768, held to one prefill of all 32768 tokens at 5e-2 of the row's
   max |logit|, #8 once a layer and prefill, LONG_500K's skip printed;
   then recurrentgemma-2b's LONG_500K at its published B = 1: a
   4096-token prefill at capacity 524288 (each window a ring of 2048
   rows, the caches ``cache_specs``') and 8 decode steps, the peak
   memory; (e) the five ``examples/torch_*.py`` at once as
   subprocesses on the card at the smallest sizes their flags allow,
   each exiting 0, their seconds printed;
7. run Algorithm 1 on vgg11 at its published widths through
   ``make_adapter("vgg11", scale="full")`` and ``PruningSession(...).run()``
   (the family's recipe cut to 4 prune rounds of 100 steps at a 5 %
   rate, batch 128, ``SyntheticImages``), print every round's event, the accuracies, the
   round and step times and the hardware report's crossbar savings,
   the paper's ReRAM model of the ticket (``core.perf_model``: the
   iso-area training speedup and the iso-performance crossbars of the
   modelled chip, not times of this card), export, re-import and
   finetune the ticket; then run kernel #9 on
   every pruned leaf of the ticket (held to its plain version and to
   the host crossbar count, at the session's geometry and at 64 x 256),
   retrain an FC-tiling variant of vgg11 (``fc=(512,)``, a test variant)
   under a ~25 %-live FC mask checking its bsmm launches per step, and
   run the LTP baseline's product (kernel #5) on its FC layer (on the
   CUDA-core ``fma`` kernel, split over K); with every kernel count set
   to 0 before and read after;
8. check one full-width resnet18 train step on the card against the
   CPU (float32, TF32 off);
9. the sparsity lint (``repro_torch.analysis``), outside inference mode
   and after every other phase: (a) ``lint --kernels`` clean, then every
   ``default_cases()`` launch spec held to its kernel — outputs and split
   workspaces filled with NaN before the launch and every element the
   spec writes finite after it, nothing written outside the spec's
   region, NaN under dead weight tiles (#1-#3, #1b, #3b) and in pool
   rows past a length or off the table (#6, #7) kept out, the result
   held to the plain version, the launch on the spec's route and split
   count, and each wgmma case's shared memory the library's figure; (b)
   with every kernel count set to 0, ``lint_arch`` on llama3.2-3b at
   full width cut to 4 layers on the card: 0 errors, and real launches
   in every audited closure (prefill: #1/#2 on ``wgmma`` and #8; decode:
   ``stream``; paged decode: #6; the train step: #3 and #4); (c) the
   tiny ``lint --all`` on the card, each arch's findings equal to the
   CPU's; the counts read after (c) are the lint path's launches
   (``launches_lint`` in the kernels line, the cases in ``lint_cases``).

Phase 2 also holds the expert-batched forward, dx and dw (#1, #3, #4
over E experts, one launch) at deepseek-v3's expert shapes, E = 32 and
320, 200 and 40 rows an expert (and three E = 2 cases whose rules
split), bf16 and f32, each call to its route and split count, twice
bitwise equal, dw zero on tiles dead in the union and nonzero on a tile
dead in one expert alone, dx zero under a K-row tile dead in the union,
and at C = 320 a row's forward and dx bits unchanged when the other
rows and experts change; it times the three at C = 320 beside
torch.bmm.
Phase 2 holds the 2-D block-sparse forward (#1, #2) at 8, 63, 64, 128,
300, 512, 1000 and 1024 rows and dx (#3) and dw (#4) at 1000 and 1024
(dx also with an all-dead K-row tile), each call to the route and
split count its plan gives (``launches_by_route``, ``split_launches``),
two calls bitwise equal, and, at 8 and 512 rows, a row's bits
unchanged when the other rows change; it times #1/#2 at 8, 512 and
1024 rows and #3/#4 at 1024 at all four llama shapes.  The serving,
retrain and CNN phases hold #1–#4 to the routes and split launches
their rows and plans give.
Phase 2 also holds tile stats (#9) and the masked LTP product (#5)
against their plain versions and times them: #5 on every kernel
(``stream`` below 64 rows, ``wgmma`` for bf16 from 64, ``fma`` for f32
from 64, each call held to its kernel's count and its split count), two
calls bitwise equal, NaN under a dead tile
kept out and NaN under a live tile's zero let through as the plain
version does, and the CNN path's FC shape timed; paged attention (#6,
#7) with NaN behind dead table entries and past each length, row by
row alone held bitwise to the batch, #7 in bf16 on its ``wgmma``
kernel and in f32 on its CUDA-core one.  Before the last line it
prints ``{"kernels": [...]}`` (per kernel: its launches in its path's
run — llama serving for the 2-D forward kernels and GQA paged
attention, retraining for dx and dw, deepseek serving for the batched
bsmm and the fused-V kernel, the deepseek retrain for the batched dx and
dw, the LTP MLP and the CNN path for #5, the
CNN path for #9, the control plane for flash attention (#8), and for
#1–#4 also the LM session's (``launches_lm_session``) and this slice's
paths' (``launches_serve_hybrid``, ``launches_retrain_hybrid``,
``launches_serve_command_r``, ``launches_serve_vlm``,
``launches_retrain_vlm``, ``launches_serve_llama4``; #1b's
``launches_serve_llama4``; #1/#2/#1b/#6/#8's ``launches_distributed``,
by leg and rank, every leg (g) kernel's ``launches_families`` by
rank and ``families_max_abs_err`` at its ranks' shapes, #1/#2/#6/#8's
``launches_launch`` by leg of the
entry points' phase, and #1/#2/#6/#8's ``distributed_shapes``, their checks
and times at leg (b)'s local shapes; #6's ``hd96`` and #8's ``hd256`` and
``hd64_hd96`` entries with those widths' times and their launches on
the serving paths, #8's registers and spills) — its error
against the plain version, its time, the plain version's, the bound and
the library call's; #1–#5, the batched forms and #7 their launches by
route, #1–#5 and the batched forms their split launches, #5 also by
path), the serving, LTP MLP,
control-plane, gradient-check, retrain, LM session, deepseek and CNN
summaries,
each phase's seconds and the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Longer records go to
``chiprun_out/``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

BSMM_SHAPES = ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072))
GRAD_ROWS = (1024, 1000)      # LMAdapter's 8 x 128 tokens, and ragged
# decode (8 slots), the stream route's last row count, the wgmma/fma
# routes' first, prefill buckets and ragged prefill, then retraining
BSMM_ROWS = (8, 63, 64, 128, 300, 512) + GRAD_ROWS
BSMM_TIMED_ROWS = (8, 512, 1024)
LIVE_FRACTION = 0.25


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


_TIMING_STREAM = []     # the one side stream time_ms warms up and captures on


def time_ms(fn, iters: int = 20, graph: bool = True) -> float:
    """Mean device milliseconds per call over ``iters`` calls (CUDA
    events).  With ``graph`` the calls are captured once into a CUDA
    graph and replayed, so that host launch overhead does not hide the
    device time of a kernel of a few microseconds; the plain versions,
    which copy host indices, run eagerly.  Warm-up, capture and timing
    run on one side stream, so that what a kernel allocates once per
    stream (bsmm's split workspace) exists before the capture."""
    if not _TIMING_STREAM:
        _TIMING_STREAM.append(torch.cuda.Stream())
    stream = _TIMING_STREAM[0]
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for i in range(3):
            fn(i)
        torch.cuda.synchronize()
        run = lambda: [fn(i) for i in range(iters)]     # noqa: E731
        if graph:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=stream):
                run()
            run = g.replay
            run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tolerance(dtype, ref) -> float:
    """bfloat16: 1e-2 of the output scale (outputs round to 8-bit
    mantissas and the two sums run in different orders); float32:
    1e-4 of it (K up to 8192 products summed in another order)."""
    scale = max(1.0, ref.float().abs().max().item())
    return (1e-2 if dtype == torch.bfloat16 else 1e-4) * scale


def random_bitmap(rng, K: int, N: int):
    """~25 % live 128x128 tiles; column tile 0 entirely dead."""
    bm = rng.random((K // 128, N // 128)) < LIVE_FRACTION
    bm[:, 0] = False
    return bm


def bsmm_bound_ms(M, K, N, plan, elem, dtype_name, experts=1) -> tuple:
    """Each expert's rows' live columns, live weight tiles and output
    once (one plan for all experts), or their flops."""
    live_k = len(set(int(k) for j in range(len(plan.counts))
                     for k in plan.idx[j, :plan.counts[j]]))
    nbytes = (experts * (M * live_k * 128 * elem
                         + plan.live_tiles * 128 * 128 * elem + M * N * elem)
              + plan.idx.size * 4 + plan.counts.size * 4)
    flops = 2.0 * experts * M * plan.live_tiles * 128 * 128
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# (bias, activation) cases; (None, None) is the backward's pre-activation
# recompute
EPILOGUES = ((None, "silu"), ("bias", "silu"), ("bias", "relu"),
             ("bias", "gelu"), ("bias", None), (None, None))


def held(fn, want_route, want_splits, *args, **kw):
    """``fn(*args, **kw)`` (a 2-D bsmm, dx or dw wrapper), required to
    launch once on ``want_route`` and to count as split exactly when
    ``want_splits`` > 1."""
    before = dict(fn.launches_by_route)
    s0 = fn.split_launches
    out = fn(*args, **kw)
    after = fn.launches_by_route
    require({k: after[k] - before[k] for k in after}
            == {k: int(k == want_route) for k in after}
            and fn.split_launches - s0 == int(want_splits > 1),
            f"{fn.__name__} did not run on {want_route} with {want_splits} "
            "splits")
    return out


def check_bsmm(B, shapes=BSMM_SHAPES, rows=BSMM_ROWS, epilogues=EPILOGUES,
               timed=True, seed=1):
    """Both 2-D bsmm kernels against their plain versions at every shape,
    each call held to the route and split count its plan gives, two
    calls bitwise equal, and at 8 and 512 rows row 0's bits unchanged
    when the other rows change; with ``timed``, times at the bfloat16
    rows of BSMM_TIMED_ROWS.  Returns (errors, times)."""
    rng = np.random.default_rng(seed)
    dev = "cuda"
    err = {"bsmm": 0.0, "bsmm_epilogue": 0.0}
    times = []
    for dtype in (torch.bfloat16, torch.float32):
        for K, N in shapes:
            bm = random_bitmap(rng, K, N)
            plan = B.make_tile_plan(np.kron(bm, np.ones((128, 128), bool)))
            require(int((plan.counts == 0).sum()) > 0, "no dead column")
            g = torch.Generator(device=dev).manual_seed(K + N)
            w = (torch.randn(K, N, device=dev, generator=g) / K ** 0.5
                 ).to(dtype)
            bias = torch.randn(N, device=dev, generator=g).to(dtype)
            for M in rows:
                x = torch.randn(M, K, device=dev, generator=g).to(dtype)
                route, S = plan.route_and_splits("fwd", M, dtype)
                got = held(B.bsmm, route, S, x, w, plan)
                cases = [("bsmm", got, B.bsmm_plain(x, w, plan))]
                same = torch.equal(got, B.bsmm(x, w, plan))
                for b, act in epilogues:
                    b = bias if b == "bias" else None
                    e_got = held(B.bsmm_epilogue, route, S, x, w, plan, b,
                                 act)
                    same &= torch.equal(
                        e_got, B.bsmm_epilogue(x, w, plan, b, act))
                    cases.append(("bsmm_epilogue", e_got,
                                  B.bsmm_epilogue_plain(x, w, plan, b, act)))
                require(same, f"two bsmm calls differ at M={M} K={K} N={N} "
                        f"{dtype}")
                if M in (8, 512):
                    other = x.clone()
                    other[1:] = torch.randn(M - 1, K, device=dev,
                                            generator=g).to(dtype)
                    require(torch.equal(B.bsmm(other, w, plan)[0], got[0])
                            and torch.equal(
                                B.bsmm_epilogue(other, w, plan, bias,
                                                "silu")[0],
                                B.bsmm_epilogue(x, w, plan, bias,
                                                "silu")[0]),
                            f"a bsmm row depends on the other rows at M={M} "
                            f"K={K} N={N} {dtype}")
                torch.cuda.synchronize()
                for name, got_, want in cases:
                    e = (got_.float() - want.float()).abs().max().item()
                    tol = tolerance(dtype, want)
                    print(f"check {name} {str(dtype)[6:]} M={M} K={K} N={N} "
                          f"{route} splits={S} max_abs_err={e:.3e} "
                          f"tol={tol:.3e}")
                    require(torch.isfinite(got_).all().item(),
                            f"{name} non-finite")
                    require(e <= tol, f"{name} disagrees with its plain "
                            f"version at M={M} K={K} N={N} {dtype}")
                    err[name] = max(err[name], e)
                if timed and dtype == torch.bfloat16 and M in BSMM_TIMED_ROWS:
                    times.append(time_bsmm(B, x, w, bm, plan, M, K, N))
            del w
    return err, times


def time_bsmm(B, x, w, bm, plan, M, K, N):
    """Kernel, plain and torch.matmul (on the masked dense weight) times,
    cycling weight copies so that the weights come from device memory
    as they do across 28 layers."""
    copies = max(2, int(400e6 // (w.numel() * w.element_size())) + 1)
    ws = [w.clone() for _ in range(copies)]
    dense = w * torch.as_tensor(np.kron(bm, np.ones((128, 128))),
                                dtype=w.dtype, device=w.device)
    ds = [dense.clone() for _ in range(copies)]
    b = torch.zeros(N, dtype=x.dtype, device=x.device)
    route, S = plan.route_and_splits("fwd", M, x.dtype)
    row = {"M": M, "K": K, "N": N, "dtype": "bfloat16", "route": route,
           "splits": S, "live_tiles": plan.live_tiles,
           "total_tiles": plan.total_tiles}
    row["bsmm_ms"] = time_ms(lambda i: B.bsmm(x, ws[i % copies], plan))
    row["bsmm_epilogue_ms"] = time_ms(
        lambda i: B.bsmm_epilogue(x, ws[i % copies], plan, b, "silu"))
    row["plain_ms"] = time_ms(lambda i: B.bsmm_plain(x, ws[i % copies], plan),
                              iters=5, graph=False)
    row["epilogue_plain_ms"] = time_ms(
        lambda i: B.bsmm_epilogue_plain(x, ws[i % copies], plan, b, "silu"),
        iters=5, graph=False)
    row["matmul_ms"] = time_ms(lambda i: torch.matmul(x, ds[i % copies]))
    row["bound_ms"], row["bound_by"] = bsmm_bound_ms(M, K, N, plan, 2,
                                                     "bfloat16")
    print("time bsmm " + json.dumps(row))
    return row


def grad_bound_ms(kind, M, K, N, plan, elem, dtype_name,
                  experts=1) -> tuple:
    """Least time for dx or dw (of each of ``experts`` experts sharing
    the plan, M rows each): bytes each input read once and the output
    written once (live columns and live tiles of the inputs; dw's whole
    dense grad, whose dead tiles are zeros), the plan's indices once, or
    the live tiles' flops, whichever is larger."""
    live_n = int((plan.counts > 0).sum())
    live_k = int((plan.counts_t > 0).sum())
    L = plan.live_tiles
    if kind == "dx":
        nbytes = (experts * (M * live_n * 128 * elem + L * 128 * 128 * elem
                             + M * K * elem)
                  + plan.idx_t.size * 4 + plan.counts_t.size * 4)
    else:
        nbytes = (experts * (M * live_k * 128 * elem + M * live_n * 128 * elem
                             + K * N * elem) + 2 * L * 4)
    flops = 2.0 * experts * M * L * 128 * 128
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_bsmm_grads(B, shapes=BSMM_SHAPES, timed=True, seed=2,
                     rows=GRAD_ROWS):
    """dx and dw kernels against their plain versions at ``shapes`` (the
    four llama3.2-3b projection shapes by default) and ``rows`` (M =
    1024 and a ragged 1000 by default), bf16 and f32; each call held to its route and split
    count, two dx and two dw calls bitwise equal, dw exactly zero on
    dead tiles; then dx at a plan with an all-dead K-row tile (zeros
    there); with ``timed``, times at bf16 M = 1024.  Returns (errors,
    times)."""
    rng = np.random.default_rng(seed)
    dev = "cuda"
    err = {"bsmm_dx": 0.0, "bsmm_dw": 0.0}
    times = []
    for dtype in (torch.bfloat16, torch.float32):
        for K, N in shapes:
            bm = random_bitmap(rng, K, N)
            plan = B.make_tile_plan(np.kron(bm, np.ones((128, 128), bool)))
            dead = ~torch.as_tensor(bm, device=dev).repeat_interleave(
                128, 0).repeat_interleave(128, 1)
            g_ = torch.Generator(device=dev).manual_seed(K * 7 + N)
            w = (torch.randn(K, N, device=dev, generator=g_) / K ** 0.5
                 ).to(dtype)
            for M in rows:
                x = torch.randn(M, K, device=dev, generator=g_).to(dtype)
                g = torch.randn(M, N, device=dev, generator=g_).to(dtype)
                route, S = plan.route_and_splits("dw", M, dtype)
                dw = held(B.bsmm_dw, route, S, x, g, plan)
                dx_route, dx_S = plan.route_and_splits("dx", M, dtype)
                dx = held(B.bsmm_dx, dx_route, dx_S, g, w, plan)
                cases = [("bsmm_dx", dx, B.bsmm_dx_plain(g, w, plan)),
                         ("bsmm_dw", dw, B.bsmm_dw_plain(x, g, plan))]
                require(torch.equal(dw, B.bsmm_dw(x, g, plan)),
                        f"two bsmm_dw calls differ at M={M} K={K} N={N}")
                require(torch.equal(dx, B.bsmm_dx(g, w, plan)),
                        f"two bsmm_dx calls differ at M={M} K={K} N={N}")
                torch.cuda.synchronize()
                for name, got, want in cases:
                    e = (got.float() - want.float()).abs().max().item()
                    tol = tolerance(dtype, want)
                    route_s = f"{dx_route} splits={dx_S}" \
                        if name == "bsmm_dx" else f"{route} splits={S}"
                    print(f"check {name} {str(dtype)[6:]} M={M} K={K} N={N} "
                          f"{route_s} max_abs_err={e:.3e} tol={tol:.3e}")
                    require(torch.isfinite(got).all().item(),
                            f"{name} non-finite")
                    require(e <= tol, f"{name} disagrees with its plain "
                            f"version at M={M} K={K} N={N} {dtype}")
                    err[name] = max(err[name], e)
                require(bool((dw[dead] == 0).all().item()),
                        f"bsmm_dw wrote a dead tile at K={K} N={N}")
                if timed and dtype == torch.bfloat16 and M == GRAD_ROWS[0]:
                    times.append(time_grads(B, x, g, w, bm, plan, M, K, N))
                del x, g, dx, dw, cases
            del w, dead
            torch.cuda.empty_cache()
    err["bsmm_dx"] = max(err["bsmm_dx"], check_dx_dead_rows(B, rng))
    return err, times


def check_dx_dead_rows(B, rng):
    """dx at 3072x1024 with K-row tile 0 all dead, ragged 1000 rows, bf16
    and f32, each on its route: zeros in that tile's 128 columns and the
    plain version elsewhere.  Returns the largest error."""
    K, N = BSMM_SHAPES[1]
    bm = random_bitmap(rng, K, N)
    bm[0] = False
    bm[1, 1] = True               # and a live tile, so no list is all empty
    plan = B.make_tile_plan(np.kron(bm, np.ones((128, 128), bool)))
    g_ = torch.Generator(device="cuda").manual_seed(17)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        w = (torch.randn(K, N, device="cuda", generator=g_) / K ** 0.5
             ).to(dtype)
        g = torch.randn(1000, N, device="cuda", generator=g_).to(dtype)
        route, S = plan.route_and_splits("dx", 1000, dtype)
        got = held(B.bsmm_dx, route, S, g, w, plan)
        want = B.bsmm_dx_plain(g, w, plan)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        tol = tolerance(dtype, want)
        zeros = bool((got[:, :128] == 0).all().item())
        print(f"check bsmm_dx {str(dtype)[6:]} M=1000 K={K} N={N} {route} "
              f"splits={S} dead K-row tile 0 zero={zeros} "
              f"max_abs_err={e:.3e} tol={tol:.3e}")
        require(zeros and e <= tol, f"bsmm_dx at an all-dead K-row tile "
                f"({dtype})")
        worst = max(worst, e)
    return worst


def time_grads(B, x, g, w, bm, plan, M, K, N):
    """dx and dw kernel, plain and library times (library: torch.matmul
    of g with the masked dense weight transposed, and of x^T with g),
    cycling operand copies so that they come from device memory."""
    copies = max(2, int(400e6 // (w.numel() * w.element_size())) + 1)
    ops = [(w.clone(), x.clone(), g.clone()) for _ in range(copies)]
    dense = w * torch.as_tensor(np.kron(bm, np.ones((128, 128))),
                                dtype=w.dtype, device=w.device)
    ds = [dense.clone() for _ in range(copies)]
    xt = [o[1].T for o in ops]
    route, S = plan.route_and_splits("dw", M, x.dtype)
    dx_route, dx_S = plan.route_and_splits("dx", M, x.dtype)
    row = {"M": M, "K": K, "N": N, "dtype": "bfloat16", "dw_route": route,
           "dw_splits": S, "dx_route": dx_route, "dx_splits": dx_S,
           "live_tiles": plan.live_tiles, "total_tiles": plan.total_tiles}
    row["dx_ms"] = time_ms(lambda i: B.bsmm_dx(ops[i % copies][2],
                                               ops[i % copies][0], plan))
    row["dw_ms"] = time_ms(lambda i: B.bsmm_dw(ops[i % copies][1],
                                               ops[i % copies][2], plan))
    row["dx_plain_ms"] = time_ms(lambda i: B.bsmm_dx_plain(g, w, plan),
                                 iters=5, graph=False)
    row["dw_plain_ms"] = time_ms(lambda i: B.bsmm_dw_plain(x, g, plan),
                                 iters=5, graph=False)
    row["dx_library_ms"] = time_ms(
        lambda i: torch.matmul(ops[i % copies][2], ds[i % copies].T))
    row["dw_library_ms"] = time_ms(
        lambda i: torch.matmul(xt[i % copies], ops[i % copies][2]))
    for kind in ("dx", "dw"):
        row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = grad_bound_ms(
            kind, M, K, N, plan, 2, "bfloat16")
    print("time bsmm_grads " + json.dumps(row))
    return row


PAGED_LENGTHS = [1, 127, 128, 129, 300, 511, 64, 1000]


def paged_inputs(dtype, g, Hq, Hkv, hd, fused):
    """Batch 8 at the lengths above, a NaN scratch block behind every
    dead table entry and NaN in the rows past each length inside its
    last live block; ``fused`` leaves out the value pool (values are
    the first lanes of each key row)."""
    B_, T, NB = 8, 128, 8
    P = 1 + sum(-(-n // T) for n in PAGED_LENGTHS) + 2
    kp = torch.randn(P, T, Hkv, hd, device="cuda", generator=g).to(dtype)
    kp[0] = float("nan")          # scratch block: dead table entries
    vp = None
    if not fused:
        vp = torch.randn(P, T, Hkv, hd, device="cuda", generator=g).to(dtype)
        vp[0] = float("nan")
    tables = torch.zeros(B_, NB, dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(PAGED_LENGTHS):
        for j in range(-(-n // T)):
            tables[b, j] = nxt
            nxt += 1
        tail = n - (n - 1) // T * T           # live rows of the last block
        for pool in (kp, vp):
            if pool is not None:
                pool[nxt - 1, tail:] = float("nan")
    q = torch.randn(B_, Hq, hd, device="cuda", generator=g).to(dtype)
    lens = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables.cuda(), lens


def check_paged(PA, Hq=24, Hkv=8, hd=128, dv=None, scale=None, seed=7,
                fused_routes=None):
    """Paged attention against its plain version, bf16 and f32, each
    row's output also computed alone and held bitwise to its output in
    the batch, two batch calls bitwise equal, timed in bf16: by default
    the GQA form (kernel #6) at llama3.2-3b's heads; with ``dv`` the
    fused-V form (kernel #7), values the first dv lanes of each key
    row, every call held to the route ``fused_routes`` names for its
    dtype."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    fused = dv is not None
    name = "paged_attention_fused_v" if fused else "paged_attention"
    scale = scale or hd ** -0.5
    err = 0.0
    row = None
    by_route = PA.paged_attention.fused_launches_by_route
    for dtype in (torch.bfloat16, torch.float32):
        q, kp, vp, tables, lens = paged_inputs(dtype, g, Hq, Hkv, hd, fused)
        before = dict(by_route)
        got = PA.paged_attention(q, kp, vp, tables, lens, scale=scale,
                                 v_dim=dv)
        require(torch.equal(got, PA.paged_attention(
            q, kp, vp, tables, lens, scale=scale, v_dim=dv)),
            f"two {name} calls differ ({dtype})")
        want = PA.paged_attention_ref(q, kp, vp, tables, lens, scale=scale,
                                      v_dim=dv)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        tol = tolerance(dtype, want)
        print(f"check {name} {str(dtype)[6:]} B=8 Hq={Hq} Hkv={Hkv} "
              f"hd={hd} dv={dv or hd} lengths={lens.tolist()} "
              f"max_abs_err={e:.3e} tol={tol:.3e}")
        require(torch.isfinite(got).all().item(),
                f"{name} saw a dead (NaN) block")
        require(e <= tol, f"{name} disagrees ({dtype})")
        # batch invariance: each row alone gives the bits it had in the batch
        alone = [torch.equal(PA.paged_attention(
            q[b:b + 1].contiguous(), kp, vp, tables[b:b + 1].contiguous(),
            lens[b:b + 1].contiguous(), scale=scale, v_dim=dv)[0], got[b])
            for b in range(len(PAGED_LENGTHS))]
        print(f"check {name} {str(dtype)[6:]} row alone == in batch: {alone}")
        require(all(alone), f"{name} is not batch-invariant ({dtype})")
        if fused_routes:
            calls = 2 + len(PAGED_LENGTHS)
            got_routes = {k: by_route[k] - before[k] for k in by_route}
            print(f"check {name} {str(dtype)[6:]} routes {got_routes}")
            require(got_routes == {k: calls * (k == fused_routes[dtype])
                                   for k in by_route},
                    f"{name} did not run on {fused_routes[dtype]} ({dtype})")
        err = max(err, e)
        if dtype == torch.bfloat16:
            row = time_paged(PA, name, q, kp, vp, tables, lens, scale, dv)
    return err, row


def time_paged(PA, name, q, kp, vp, tables, lens, scale, dv):
    B_, Hq, hd = q.shape
    Hkv = kp.shape[2]
    dv = dv or hd
    # the library yardstick reads dead entries and rows too
    kp = torch.nan_to_num(kp, nan=0.0)
    if vp is not None:
        vp = torch.nan_to_num(vp, nan=0.0)
    row = {"B": B_, "Hq": Hq, "Hkv": Hkv, "hd": hd, "dv": dv,
           "lengths": lens.tolist()}
    # cycle pool copies: a model's layers of pools do not stay in the L2
    pool_bytes = (kp.numel() + (0 if vp is None else vp.numel())) \
        * kp.element_size()
    copies = int(400e6 // pool_bytes) + 1
    pools = [(kp.clone(), None if vp is None else vp.clone())
             for _ in range(copies)]
    row["ms"] = time_ms(lambda i: PA.paged_attention(
        q, *pools[i % copies], tables, lens, scale=scale,
        v_dim=None if vp is not None else dv))
    row["plain_ms"] = time_ms(lambda i: PA.paged_attention_ref(
        q, kp, vp, tables, lens, scale=scale,
        v_dim=None if vp is not None else dv), iters=5, graph=False)
    # yardstick: SDPA on K/V already gathered to dense, each KV head
    # expanded to its query heads (fused: V = K[..., :dv])
    G = Hq // Hkv
    k = PA.paged_gather(kp, tables).permute(0, 2, 1, 3)
    k = k.repeat_interleave(G, dim=1).contiguous()
    if vp is None:
        v = k[..., :dv].contiguous()
        row["route"] = PA.fused_route(PA._check_geometry(
            q, kp, vp, tables, lens, dv), q.dtype)
    else:
        v = PA.paged_gather(vp, tables).permute(0, 2, 1, 3)
        v = v.repeat_interleave(G, dim=1).contiguous()
    L = k.shape[2]
    mask = (torch.arange(L, device="cuda")[None] < lens[:, None].long())
    mask = mask[:, None, None, :]
    qq = q[:, :, None, :]
    row["library_ms"] = time_ms(lambda i: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, scale=scale))
    elem = q.element_size()
    live = int(lens.sum().item())
    row_bytes = Hkv * (hd if vp is None else 2 * hd) * elem
    nbytes = (q.numel() * elem + live * row_bytes + B_ * Hq * dv * elem
              + tables.numel() * 4 + B_ * 4)
    flops = live * Hq * 2.0 * (hd + dv)
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / PEAK_FLOPS["bfloat16"] * 1e3
    row["bound_ms"] = max(t_b, t_o)
    row["bound_by"] = "bytes" if t_b >= t_o else "operations"
    print(f"time {name} " + json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# kernel #8: flash attention, the serving prefill's attention
# ---------------------------------------------------------------------------
# (S, Hq, Hkv, hd, dv, causal, dtype): llama3.2-3b's prefill at a ragged
# prompt, a bucket and a long prompt; one full (non-causal) and one
# float32 shape; deepseek-v3's MLA prefill (q/k width 192, values 128)
FLASH_SHAPES = ((300, 24, 8, 128, 128, True, torch.bfloat16),
                (512, 24, 8, 128, 128, True, torch.bfloat16),
                (4096, 24, 8, 128, 128, True, torch.bfloat16),
                (512, 24, 8, 128, 128, False, torch.bfloat16),
                (512, 24, 8, 128, 128, True, torch.float32),
                (512, 128, 128, 192, 128, True, torch.bfloat16),
                # the smallest serving bucket, and one between
                (128, 24, 8, 128, 128, True, torch.bfloat16),
                (1024, 24, 8, 128, 128, True, torch.bfloat16),
                # recurrentgemma-2b's local attention: one 256-wide KV
                # head under 10 query heads, a prompt and a full window
                (300, 10, 1, 256, 256, True, torch.bfloat16),
                (2048, 10, 1, 256, 256, True, torch.bfloat16),
                (300, 10, 1, 256, 256, True, torch.float32),
                # phi-3-vision's prompt (32 heads of 96: the second 64-
                # column chunk half past the inner dim), whisper-tiny's
                # encoder over 1500 frames (full) and a decoder prompt
                (300, 32, 32, 96, 96, True, torch.bfloat16),
                (1500, 6, 6, 64, 64, False, torch.bfloat16),
                (64, 6, 6, 64, 64, True, torch.bfloat16),
                (300, 32, 32, 96, 96, True, torch.float32),
                # the launch phase's PREFILL_32K cell: llama3.2-3b's
                # prefill of 32767 tokens (then DECODE_32K) and of 32768
                (32767, 24, 8, 128, 128, True, torch.bfloat16),
                (32768, 24, 8, 128, 128, True, torch.bfloat16))
# above this length SDPA, the yardstick, gets k and v with their heads
# repeated rather than ``enable_gqa``: a backend that materialised the
# scores would hold Hq S^2 float32 of them (103 GB at S = 32767)
FLASH_SDPA_GQA_MAX_S = 8192
# #8 / SDPA of the CUDA-core kernel that ran every dtype before the
# wgmma route (an H100 80GB HBM3 at 700 W; PERF.md §6), keyed
# (S, Hq, causal)
FLASH_SDPA_RATIO_BEFORE = {(300, 24, True): 11.0, (512, 24, True): 23.3,
                           (4096, 24, True): 59.8, (512, 24, False): 31.9,
                           (512, 128, True): 44.5}


def flash_bound_ms(S, Hq, Hkv, hd, dv, causal, elem, dtype_name) -> tuple:
    """q, k, v read once and the output written once, or the flops of
    q k^T and p @ v over the (causal: lower-triangle) score pairs."""
    nbytes = S * (Hq * hd + Hkv * (hd + dv) + Hq * dv) * elem
    pairs = S * (S + 1) / 2 if causal else S * S
    flops = 2.0 * Hq * pairs * (hd + dv)
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def check_flash(FA, shapes=FLASH_SHAPES):
    """Flash attention against its plain version at every shape above
    (or ``shapes``),
    with the tolerance printed; times kernel, plain version and SDPA
    (the library yardstick, never on the path).  Each call must run the
    route of its dtype (bfloat16: the wgmma kernel, float32: the
    CUDA-core one); every bfloat16 shape must beat its plain version
    and, where the CUDA-core kernel was timed, its ratio to SDPA.  Returns
    (error, rows)."""
    g = torch.Generator(device="cuda").manual_seed(13)
    err, rows = 0.0, []
    for S, Hq, Hkv, hd, dv, causal, dtype in shapes:
        q = torch.randn(1, S, Hq, hd, device="cuda", generator=g).to(dtype)
        k = torch.randn(1, S, Hkv, hd, device="cuda", generator=g).to(dtype)
        v = torch.randn(1, S, Hkv, dv, device="cuda", generator=g).to(dtype)
        route = "wgmma" if dtype == torch.bfloat16 else "simt"
        before = FA.flash_attention.launches_by_route[route]
        got = FA.flash_attention(q, k, v, causal=causal)
        require(FA.flash_attention.launches_by_route[route] == before + 1,
                f"flash_attention {dtype} did not run the {route} kernel")
        want = FA.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        tol = tolerance(dtype, want)
        name = str(dtype)[6:]
        print(f"check flash_attention {name} ({route}) S={S} Hq={Hq} Hkv={Hkv} "
              f"hd={hd} dv={dv} causal={causal} max_abs_err={e:.3e} "
              f"tol={tol:.3e}" + (" (the f32-p CUDA-core kernel: 3.9e-3)"
                                  if route == "wgmma" else ""))
        require(torch.isfinite(got).all().item(), "flash_attention non-finite")
        require(e <= tol, f"flash_attention disagrees with its plain version "
                f"at S={S} Hq={Hq} hd={hd} {dtype}")
        err = max(err, e)
        row = {"S": S, "Hq": Hq, "Hkv": Hkv, "hd": hd, "dv": dv,
               "causal": causal, "dtype": name, "route": route,
               "max_abs_err": e}
        row["ms"] = time_ms(lambda i: FA.flash_attention(q, k, v,
                                                         causal=causal))
        row["plain_ms"] = time_ms(
            lambda i: FA.flash_attention_plain(q, k, v, causal=causal),
            iters=3, graph=False)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        gqa = Hq != Hkv
        if gqa and S > FLASH_SDPA_GQA_MAX_S:
            kt, vt = (t.repeat_interleave(Hq // Hkv, 1) for t in (kt, vt))
            gqa = False
        row["library_ms"] = time_ms(lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=gqa))
        row["bound_ms"], row["bound_by"] = flash_bound_ms(
            S, Hq, Hkv, hd, dv, causal, q.element_size(), name)
        row["sdpa_ratio"] = row["ms"] / row["library_ms"]
        row["bound_ratio"] = row["ms"] / row["bound_ms"]
        print("time flash_attention " + json.dumps(row))
        if route == "wgmma":
            was = FLASH_SDPA_RATIO_BEFORE.get((S, Hq, causal))
            print(f"flash_attention S={S} Hq={Hq} causal={causal}: #8/SDPA "
                  f"{row['sdpa_ratio']:.2f}x (CUDA-core kernel: "
                  f"{f'{was}x' if was else 'not timed'}), #8/bound "
                  f"{row['bound_ratio']:.1f}x, #8/plain "
                  f"{row['ms'] / row['plain_ms']:.3f}")
            require(row["ms"] < row["plain_ms"], f"flash_attention S={S} "
                    "is slower than its plain version")
            require(was is None or row["sdpa_ratio"] < was,
                    f"flash_attention S={S} Hq={Hq} lost ground to SDPA")
        rows.append(row)
        del q, k, v, got, want, qt, kt, vt
    return err, rows


def flash_build_report(FA, log: str) -> dict:
    """The bf16 kernel's registers and spills per instantiation, from
    ``-Xptxas=-v`` in the build log, and its dynamic shared memory at
    llama's and deepseek's prefill widths."""
    import re

    regs = {}
    for entry in log.split("Compiling entry function")[1:]:
        m = re.search(r"flash_attention_wgmma_kernelILi(\d)ELi(\d)ELi(\d+)E",
                      entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", entry)
        used = re.search(r"Used (\d+) registers", entry)
        if m and spill and used:
            regs["<%s,%s,%s>" % m.groups()] = {
                "registers": int(used.group(1)),
                "spill_bytes": int(spill.group(1)) + int(spill.group(2))}
    smem = {f"hd={hd},dv={dv}": FA.wgmma_smem_bytes(hd, dv)
            for hd, dv in ((128, 128), (192, 128), (256, 256), (96, 96),
                           (64, 64))}
    print(f"ptxas flash_attention_wgmma_kernel<HC,DC,BK>: "
          f"{json.dumps(regs) if regs else 'not rebuilt (cached library)'}; "
          f"dynamic shared memory {json.dumps(smem)} bytes")
    return {"ptxas": regs, "smem_bytes": smem}


def build_ticket(params, cfg, device, seed=1234):
    """One seeded ~25 %-live 128x128 tile bitmap per projection, shared
    by every layer (a (K, N) mask broadcast over the stacked repeats)."""
    rng = np.random.default_rng(seed)
    seg = params["segments"][0][0]
    reps = cfg.n_layers
    masks = {"attn": {}, "mlp": {}}
    for group, keys in (("attn", ("wq", "wk", "wv", "wo")),
                        ("mlp", ("up", "gate", "down"))):
        for key in keys:
            K, N = seg[group][key].shape[-2:]
            bm = torch.as_tensor(random_bitmap(rng, K, N), device=device)
            m = bm.repeat_interleave(128, 0).repeat_interleave(128, 1)
            masks[group][key] = m.expand(reps, K, N)
    return {"segments": [[masks]]}


def require_flash_routes(FA, want: int, where: str) -> None:
    """Every prefill of a bf16 model attends through the wgmma kernel:
    its route count equals the flash launches the path requires, and
    the CUDA-core (float32) kernel never runs there."""
    by_route = dict(FA.flash_attention.launches_by_route)
    print(f"{where}: flash_attention launches by route {by_route}, want "
          f"wgmma={want}, simt=0")
    require(by_route == {"wgmma": want, "simt": 0},
            f"{where}: a prefill did not attend through the wgmma kernel")


BSMM_ROUTED = ("bsmm", "bsmm_epilogue", "bsmm_dx", "bsmm_dw")
# the expert-batched wrappers, counted by route like the 2-D ones
BATCHED_ROUTED = ("bsmm_batched", "bsmm_batched_dx", "bsmm_batched_dw")


def reset_bsmm_routes(B, names=BSMM_ROUTED) -> None:
    """Set the launch, route and split counts of the named wrappers (the
    2-D or batched forward's, dx's and dw's) to 0."""
    for name in names:
        f = getattr(B, name)
        f.launches = 0
        f.split_launches = 0
        for k in f.launches_by_route:
            f.launches_by_route[k] = 0


def bsmm_routes(B, names=BSMM_ROUTED) -> dict:
    """The named wrappers' (the 2-D or batched forward's, dx's and dw's)
    launches by route and split launches."""
    return {name: {"launches_by_route": dict(getattr(B, name)
                                             .launches_by_route),
                   "split_launches": getattr(B, name).split_launches}
            for name in names}


LLAMA_PROJECTIONS = (("attn", ("wq", "wk", "wv", "wo")),
                     ("mlp", ("up", "gate", "down")))
PLAIN_PROJECTIONS = ("wq", "wk", "wv", "wo", "up", "down")   # the gate: #2


def ticket_plans(B, masks) -> dict:
    """The tile plan of each projection of a llama ticket: the union
    over its layers, as the model runs them (one stacked segment)."""
    from repro_torch.models.plans import build_decode_plan

    entry = build_decode_plan(masks)[0][0][0]
    return {key: entry[group][key]
            for group, keys in LLAMA_PROJECTIONS for key in keys}


def is_cut(plan, kind, M) -> bool:
    return plan.route_and_splits(kind, M, torch.bfloat16)[1] > 1


SERVE_LENGTHS = (5, 17, 64, 127, 128, 129, 200, 300)
PLAN_CHECK_LEN = 129        # the prompt of the plan-vs-dense prefill check
TEACHER_TOL = 5e-2          # of each logits row's max |logit| (bf16 model)
SERVE_KEYS = ("parameters", "decode_step_ms_p50", "decode_step_ms_min",
              "tokens_per_s", "ttft_p50_s", "ttft_p95_s",
              "max_memory_allocated_bytes")
SERVE_ROUTED = ("bsmm", "bsmm_epilogue", "bsmm_batched")


def watch(eng, uids=()):
    """``logits_sink``: count the non-finite logits of every sampled
    row, keep the rows of ``uids``."""
    nonfinite = [0]
    rows = {u: [] for u in uids}

    def sink(uid, row):
        nonfinite[0] += int((~np.isfinite(row)).sum())
        if uid in rows:
            rows[uid].append(row.copy())

    eng.logits_sink = sink
    return nonfinite, rows


def run_engine(eng, reqs, device):
    """Submit ``reqs`` and step the engine to idle: (sorted decode-only
    tick times in ms, seconds)."""
    for r in reqs:
        eng.submit(r)
    step_ms = []
    t0 = time.perf_counter()
    while not eng.idle:
        before = eng.report.prefills
        ts = time.perf_counter()
        eng.step()
        sync(device)
        if eng.report.prefills == before:       # a decode-only tick
            step_ms.append((time.perf_counter() - ts) * 1e3)
    return sorted(step_ms), time.perf_counter() - t0


def reset_kernel_counts(B, FA, PA) -> None:
    """Launch, route and split counts of #1/#2, #1b, #6, #7 and #8 to 0."""
    reset_bsmm_routes(B, SERVE_ROUTED)
    PA.paged_attention.launches = 0
    PA.paged_attention.fused_launches = 0
    FA.flash_attention.launches = 0
    FA.flash_attention.launches_by_route.update(wgmma=0, simt=0)


ALL_WRAPPERS = BSMM_ROUTED + BATCHED_ROUTED + ("masked_matmul",)


def routes_now(B, FA, PA, TS) -> dict:
    """{wrapper: {route: launches}} of every wrapper that launched, as
    ``launch.hlo_analysis.StepTrace.launches`` records them (#6 and #9
    launch one kernel: ``simt``)."""
    out = {n: {r: k for r, k in getattr(B, n).launches_by_route.items() if k}
           for n in ALL_WRAPPERS}
    out["flash_attention"] = {r: k for r, k in
                              FA.flash_attention.launches_by_route.items()
                              if k}
    fused = {r: k for r, k in
             PA.paged_attention.fused_launches_by_route.items() if k}
    out["paged_attention"] = dict(fused)
    if PA.paged_attention.launches:
        out["paged_attention"]["simt"] = out["paged_attention"].get(
            "simt", 0) + PA.paged_attention.launches
    if TS.tile_stats.launches:
        out["tile_stats"] = {"simt": TS.tile_stats.launches}
    return {n: v for n, v in out.items() if v}


def routes_since(before: dict, after: dict) -> dict:
    """``routes_now``'s growth between two snapshots."""
    out = {}
    for n, by in after.items():
        grew = {r: k - before.get(n, {}).get(r, 0) for r, k in by.items()}
        grew = {r: k for r, k in grew.items() if k}
        if grew:
            out[n] = grew
    return out


def kernel_counts(B, FA, PA) -> dict:
    return {"bsmm": B.bsmm.launches, "bsmm_epilogue": B.bsmm_epilogue.launches,
            "bsmm_batched": B.bsmm_batched.launches,
            "paged_attention": PA.paged_attention.launches,
            "paged_attention_fused_v": PA.paged_attention.fused_launches,
            "flash_attention": FA.flash_attention.launches}


def record_flash_calls(where):
    """Wrap ``flash_attention`` where ``where`` (modules) call it, to
    record each call's (S, causal); the kernel's own counts stay the
    wrapper's.  Returns (calls, undo)."""
    from repro_torch.kernels import flash_attention as FA

    calls = []

    def rec(q, k, v, *, causal=True, **kw):
        calls.append((q.shape[1], bool(causal)))
        return FA.flash_attention(q, k, v, causal=causal, **kw)

    saved = [(m, m.flash_attention) for m in where]
    for m, _ in saved:
        m.flash_attention = rec

    def undo():
        for m, f in saved:
            m.flash_attention = f
    return calls, undo


@contextlib.contextmanager
def moe_routes(replay=None):
    """Within it, ``models.moe._top_k`` appends each call's chosen
    experts to the yielded list; given ``replay`` (such a list), it
    returns those experts instead, call by call in order, with the
    caller's own probabilities at them."""
    from repro_torch.models import moe

    top_k, seen, queue = moe._top_k, [], list(replay or ())

    def chosen(probs, k):
        if queue:
            idx = queue.pop(0)
            return probs.gather(-1, idx), idx
        vals, idx = top_k(probs, k)
        seen.append(idx.clone())
        return vals, idx

    moe._top_k = chosen
    try:
        yield seen
    finally:
        moe._top_k = top_k


def expected_serving_routes(B, plan, cfg, pass_tokens, names) -> dict:
    """``bsmm_routes`` as a planned model implies it over passes of
    ``pass_tokens`` tokens each (bf16): every 2-D product (attention,
    MLP, shared expert; the gate on the epilogue kernel) at that many
    rows, every expert product batched at the pass's expert capacity;
    all zero without a plan."""
    from repro_torch.models.moe import expert_capacity
    from repro_torch.models.transformer import segments_of

    want = {n: {"launches_by_route": {k: 0 for k in getattr(B, n)
                                      .launches_by_route},
                "split_launches": 0} for n in names}

    def add(name, p, kind, M, n, experts=1):
        route, S = p.route_and_splits(kind, M, torch.bfloat16, experts)
        want[name]["launches_by_route"][route] += n
        want[name]["split_launches"] += n * (S > 1)

    for T in pass_tokens if plan is not None else ():
        for seg, seg_plan in zip(segments_of(cfg), plan):
            for entry in seg_plan:
                for group, keys in (entry or {}).items():
                    if group == "moe":
                        C = expert_capacity(T, cfg.moe)
                        for key in ("up", "gate", "down"):
                            if key in keys:
                                add("bsmm_batched", keys[key], "batched", C,
                                    seg.reps, cfg.moe.num_experts)
                        keys = keys.get("shared", {})
                    for key, p in keys.items():
                        add("bsmm_epilogue" if key == "gate" else "bsmm", p,
                            "fwd", T, seg.reps)
    return want


def expected_flash_calls(cfg, S) -> list:
    """(S, causal) of every flash call of one prefill of S rows: each
    encoder layer over the frames (full), each attention layer over the
    prompt (causal; a local layer only within its window)."""
    from repro_torch.configs import ATTN, LOCAL_ATTN

    n = sum(k == ATTN or (k == LOCAL_ATTN and S <= cfg.local_window)
            for k in cfg.blocks)
    return ([(cfg.encoder_seq_len, False)] * cfg.n_encoder_layers
            + [(S, True)] * n)


def rel_row_err(rows, want) -> float:
    """Largest error of engine logits rows against reference rows,
    relative to each reference row's max |logit|."""
    got = torch.as_tensor(np.stack(rows), device=want.device)
    return ((got - want).abs().amax(-1)
            / want.abs().amax(-1).clamp_min(1e-30)).max().item()


def serve_summary(cfg, params, eng, step_ms, serve_s, on_card) -> dict:
    from repro_torch._bridge import tree_leaves

    rep = eng.report
    return {"config": cfg.name, "n_layers": cfg.n_layers,
            "parameters": sum(t.numel() for t in tree_leaves(params)),
            "serve_s": serve_s, "decode_only_steps": len(step_ms),
            "decode_step_ms_p50": step_ms[len(step_ms) // 2]
            if step_ms else None,
            "decode_step_ms_min": step_ms[0] if step_ms else None,
            "tokens_per_s": rep.tokens_per_s, "ttft_p50_s": rep.ttft_p50,
            "ttft_p95_s": rep.ttft_p95,
            "max_memory_allocated_bytes":
            torch.cuda.max_memory_allocated() if on_card else None,
            "report": rep.__dict__}


def plan_prefill_check(params, cfg, eng, req, device, label) -> tuple:
    """Block-sparse prefill of ``req``'s prompt through the engine's plan
    against dense prefill on the masked weights (the same function,
    bf16 rounding in other places), at the prompt's bucket where the
    model takes masked rows, else at its length.  Returns (max abs
    error, tolerance)."""
    from repro_torch.models import transformer as tfm

    n = len(req.prompt)
    masked = tfm.supports_masked_prefill(cfg)
    S = eng._bucket(n) if masked else n
    toks = np.zeros((1, S), np.int64)
    toks[0, :n] = req.prompt
    kw = {"valid_len": torch.tensor([n], dtype=torch.int32, device=device)} \
        if masked else {}
    with torch.inference_mode():
        batch = {"tokens": torch.as_tensor(toks, device=device)}
        got, _ = tfm.prefill(params, cfg, batch, S, plan=eng.plan, **kw)
        want, _ = tfm.prefill(params, cfg, batch, S, **kw)
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = 5e-2 * scale
    same_argmax = bool((got.argmax(-1) == want.argmax(-1)).all().item())
    print(f"check {label} plan prefill vs dense masked prefill ({cfg.dtype}, "
          f"{cfg.n_layers} layers, prompt {n}, {S} rows): "
          f"max_abs_err={diff:.4e} max|logit|={scale:.4e} tol={tol:.4e} "
          f"same_argmax={same_argmax}")
    require(bool(torch.isfinite(got).all().item()), "plan prefill non-finite")
    require(diff <= tol, f"{label}'s plan prefill disagrees with dense "
            "prefill")
    return diff, tol


def prefill_rows_check(params, cfg, reqs, rows, served, device,
                       label) -> dict:
    """Each request's prefill logits row (the engine's, through the plan)
    against ``forward`` without a plan over its prompt, on the masked
    weights.  ``served``: the top-1 experts the engine chose, by the
    number of tokens routed (a prefill's: its prompt's).  Where the
    dense forward routes a token to another expert (bf16 rounding
    flips a near tie), it runs again with the engine's experts, and
    that run is held to the tolerance; both errors and the flips are
    reported."""
    from repro_torch.models import transformer as tfm

    by_tokens = {}
    for idx in served:          # (G, T/G, k): the call's T tokens
        by_tokens.setdefault(idx[..., 0].numel(), []).append(idx)
    out = {}
    for r in reqs:
        n = len(r.prompt)
        batch = {"tokens": torch.as_tensor(r.prompt[None].astype(np.int64),
                                           device=device)}
        engine_routes = by_tokens.get(n, [])
        with torch.inference_mode(), moe_routes() as dense_routes:
            lg, _ = tfm.forward(params, cfg, batch)
        require(len(dense_routes) == len(engine_routes) > 0,
                f"{label}: {len(engine_routes)} routed layers in the "
                f"engine's prefill of {n} tokens, {len(dense_routes)} in "
                "forward")
        flips = sum(int((a != b).sum().item())
                    for a, b in zip(dense_routes, engine_routes))
        err = rel_row_err(rows[r.uid][:1], lg[0, -1:].float())
        del lg
        row = {"flips": flips, "rel_err": err}
        if flips:
            with torch.inference_mode(), moe_routes(replay=engine_routes):
                lg, _ = tfm.forward(params, cfg, batch)
            row["rel_err_engine_routes"] = rel_row_err(rows[r.uid][:1],
                                                       lg[0, -1:].float())
            del lg
        out[n] = row
    print(f"check {label} prefill rows vs forward without a plan over each "
          f"prompt (tol {TEACHER_TOL} of the row's max|logit|; routed "
          f"tokens whose top-1 expert differs, and the error with the "
          f"engine's experts where any does): {json.dumps(out)}")
    require(all(row.get("rel_err_engine_routes", row["rel_err"])
                <= TEACHER_TOL for row in out.values()),
            f"{label}'s prefill logits disagree with forward")
    return out


def serve(cfg, device, *, label: str = "llama", max_new=32,
          lengths=SERVE_LENGTHS, prompt_seed: int = 5, ticket=None,
          adapter=None, capacity: int = 512, planned: bool = True,
          teacher=None, dispatch: bool = False):
    """Serve a request of every prompt length in ``lengths`` with
    ``max_new`` new tokens (one number, or one a request) through
    ``ServeEngine`` (8 slots, ``capacity``) on ``cfg``, random weights
    from a seeded generator, with ``ticket(params)``'s masks applied
    (default: ``build_ticket``'s ~25 % tile bitmaps shared by all
    layers).  ``adapter`` (an encoder-decoder's) gives the parameters,
    the engine's prefill and decode and each request's encoder frames.

    Checks: every request finishes; every logit is finite; the engine
    has a plan exactly when ``planned``; #1/#2 and #1b launch on the
    routes and split counts the plan gives at every pass's rows (a
    prefill's bucket or exact length, a decode step's 8 slots; experts
    at the pass's capacity); #6 once a global layer and decode step on
    a paged engine; #8 once an encoder layer (full) and an attention
    layer (causal) a prefill, each at its length, all on ``wgmma``; no
    other launch; a planned dense model's plan-vs-dense prefill; and
    ``teacher``: "all" holds every request's logits to a teacher-forced
    forward without a plan, "prefill" each prefill row to ``forward``
    without a plan (``prefill_rows_check``: MoE, whose capacity drops
    at decode differ from a whole-sequence forward's).  With
    ``dispatch`` it times the decode dispatch; it profiles one decode
    tick.  Returns (launches, summary)."""
    from repro_torch.configs import ATTN
    from repro_torch.core.masks import apply_masks_
    from repro_torch.kernels import bsmm as B
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import attention, encdec
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import Request, ServeEngine

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = (adapter.init_params(gen) if adapter is not None
              else tfm.init_params(gen, cfg, device=device))
    masks = ticket(params) if ticket else build_ticket(params, cfg, device)
    apply_masks_(params, masks)
    sync(device)
    setup_s = time.perf_counter() - t0
    fns = {} if adapter is None else dict(zip(("prefill_fn", "decode_fn"),
                                              adapter.serve_fns()))
    eng = ServeEngine(params=params, cfg=cfg, masks=masks, batch_slots=8,
                      capacity=capacity, device=device, **fns)
    require((eng.plan is not None) == planned,
            f"the {label} engine {'lacks' if planned else 'has'} a plan")
    frames = adapter.serve_frames if cfg.is_encoder_decoder else None
    budgets = [max_new] * len(lengths) if isinstance(max_new, int) \
        else list(max_new)
    prng = np.random.default_rng(prompt_seed)
    reqs = [Request(uid=i, prompt=prng.integers(1, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new_tokens=budgets[i],
                    frames=None if frames is None else frames(i))
            for i, n in enumerate(lengths)]
    if teacher == "prefill":        # prefills told apart by their tokens
        require(len(set(lengths)) == len(lengths) and 8 not in lengths,
                "prefill rows need distinct prompt lengths other than 8")
    nonfinite, rows = watch(eng, [r.uid for r in reqs] if teacher else ())
    calls, undo = record_flash_calls((attention, encdec))
    reset_kernel_counts(B, FA, PA)
    try:
        with (moe_routes() if teacher == "prefill"
              else contextlib.nullcontext([])) as served:
            step_ms, serve_s = run_engine(eng, reqs, device)
    finally:
        undo()
        eng.logits_sink = None
    launches = kernel_counts(B, FA, PA)
    rep = eng.report
    require(all(r.done and len(r.tokens) == r.max_new_tokens for r in reqs),
            f"not every {label} request finished")
    require(nonfinite[0] == 0, f"{nonfinite[0]} non-finite {label} logits")

    # one pass a prefill (the prompt's bucket where the model takes
    # masked rows, else its own length) or a decode step (8 slots)
    masked = tfm.supports_masked_prefill(cfg)
    prefill_rows = [eng._bucket(len(r.prompt)) if masked else len(r.prompt)
                    for r in reqs]
    require(rep.prefills == len(reqs), f"{rep.prefills} {label} prefills "
            f"for {len(reqs)} requests")
    routes = bsmm_routes(B, SERVE_ROUTED)
    want = expected_serving_routes(B, eng.plan, cfg,
                                   [8] * rep.decode_steps + prefill_rows,
                                   SERVE_ROUTED)
    want_calls = sorted(c for S in prefill_rows
                        for c in expected_flash_calls(cfg, S))
    global_layers = sum(k == ATTN for k in cfg.blocks)
    want_launches = {
        **{n: sum(want[n]["launches_by_route"].values())
           for n in SERVE_ROUTED},
        "paged_attention": rep.decode_steps * global_layers
        if eng.paged else 0,
        "paged_attention_fused_v": 0, "flash_attention": len(want_calls)}
    print(f"{label} serving ({rep.prefills} prefills, {rep.decode_steps} "
          f"decode steps, {'paged' if eng.paged else 'dense slots'}): "
          f"launches {launches}, want {want_launches}; bsmm routes "
          f"{routes}, want {want}; flash calls {len(calls)}")
    require(routes == want, f"{label}'s bsmm launches, routes or split "
            "launches do not match the model")
    require(sorted(calls) == want_calls, f"{label}'s flash calls (length, "
            "causal) do not match the model")
    require(launches == want_launches, f"{label}'s launch counts do not "
            "match the model")
    require_flash_routes(FA, len(want_calls), f"{label} serving")

    checks = {}
    if planned and cfg.moe is None:
        plan_req = next(r for r in reqs if len(r.prompt) == PLAN_CHECK_LEN)
        checks["prefill_plan_vs_dense_max_abs_err"], \
            checks["prefill_plan_vs_dense_tol"] = plan_prefill_check(
                params, cfg, eng, plan_req, device, label)
    if teacher == "all":
        held_to = teacher_forced_encdec if cfg.is_encoder_decoder \
            else teacher_forced
        errs = {r.uid: held_to(params, cfg, r, rows[r.uid], device)
                for r in reqs}
        print(f"check {label} teacher-forced forward vs engine logits "
              f"({len(reqs)} requests, prompts {list(lengths)}): max err "
              f"{max(errs.values()):.4e} of each row's max|logit| "
              f"(tol {TEACHER_TOL})")
        require(max(errs.values()) <= TEACHER_TOL, f"{label}'s engine "
                "logits disagree with the teacher-forced forward")
        checks["teacher_forced_rel_err"] = errs
    elif teacher == "prefill":
        checks["prefill_rows"] = prefill_rows_check(
            params, cfg, reqs, rows, served, device, label)
    del rows

    summary = serve_summary(cfg, params, eng, step_ms, serve_s, on_card)
    summary.update(setup_s=setup_s, launches=launches, bsmm_routes=routes,
                   flash_calls_per_prefill=len(want_calls) // len(reqs)
                   if want_calls else 0,
                   skipped_tile_fraction=rep.skipped_tile_fraction, **checks)
    if cfg.is_encoder_decoder:
        summary["cross_kv_bytes_per_slot"] = sum(
            t.numel() * t.element_size()
            for layer in eng.generations[-1].slot_caches
            for t in layer["cross"]) // eng.slots
    summary["decode_dispatch"] = time_decode_dispatch(eng, cfg, B, device) \
        if dispatch else None
    summary["decode_profile"] = profile_decode(
        eng, cfg, device, label, frames=frames) if on_card else None
    print(f"{label} serve: " + json.dumps(
        {k: summary[k] for k in SERVE_KEYS}))
    return launches, summary


def time_decode_dispatch(eng, cfg, B, device) -> dict:
    """Decode-step host time with ``bsmm_apply`` calling the forward
    kernels directly (what serving runs: gradients are off) against
    routing every planned product through the ``torch.autograd.Function``
    the retrain path uses, alternating tick by tick on one engine so
    that both see the same batch and cache lengths.  A measurement, not
    a gate."""
    from repro_torch.serve import Request

    direct = B.bsmm_apply

    def via_function(x, w, plan, bias=None, act=None):
        return B.BsmmApply.apply(x, w, bias, plan, act)

    prng = np.random.default_rng(6)
    for i in range(8):
        eng.submit(Request(uid=100 + i, prompt=prng.integers(
            1, cfg.vocab_size, size=64).astype(np.int32), max_new_tokens=41))
    ms = {"direct": [], "function": []}
    tick = 0
    try:
        while not eng.idle:
            mode = ("direct", "function")[tick % 2]
            B.bsmm_apply = direct if mode == "direct" else via_function
            before = eng.report.prefills
            ts = time.perf_counter()
            eng.step()
            sync(device)
            if eng.report.prefills == before:
                ms[mode].append((time.perf_counter() - ts) * 1e3)
                tick += 1
    finally:
        B.bsmm_apply = direct
    out = {f"{k}_ms_p50": sorted(v)[len(v) // 2] for k, v in ms.items()}
    out["steps_each"] = min(len(v) for v in ms.values())
    print(f"decode dispatch: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# the serving control plane: tickets, a fleet, hot-swap, failover,
# dense-slot decode and the command line, at full width
# ---------------------------------------------------------------------------
CP_LAYERS = 8           # llama3.2-3b's 28 layers cut: the script's time
CP_REQUESTS = 16        # fleet requests (prompts 5-300 tokens)
CP_MAX_NEW = 16
CP_SWAP_AFTER = 2       # fleet ticks before the swap lands
CP_DENSE_REQUESTS = 8
CP_TEMPERATURE = 0.8    # the sampled swap leg
CP_SAMPLE_SEED = 7
# moved streams' logits against the never-failed run's, of each stream's
# max |logit|: the model-level bf16 gate of the other cross-path checks
# (plan vs dense prefill, dense-slot vs paged).  The re-admitted part of
# a stream is prefilled again (flash attention, bsmm at prefill rows)
# where the never-failed run decoded it (paged attention, 8 rows): 1-2
# bf16 ulps of the largest logit apart, up to 1.07e-2 of it on the H100
FAILOVER_LOGITS_TOL = 5e-2


def ticket_masks(params, cfg, seed, device):
    """Masks for every ``lm_prunable`` leaf, as bool: the seeded ~25 %-live
    tile bitmap on each attention and MLP projection (shared by every
    layer, as ``build_ticket``), all-ones elsewhere."""
    from repro_torch.core.masks import lm_prunable, tree_map_with_path

    shared = build_ticket(params, cfg, device, seed=seed)["segments"][0][0]

    def mk(path, w):
        if w is None or not lm_prunable(path, w):
            return None
        group, key = path.split("/")[-2:]
        if group in shared and key in shared[group]:
            return shared[group][key].bool()
        return torch.ones(w.shape, dtype=torch.bool, device=device)
    return tree_map_with_path(mk, params)


def record_logits(router) -> dict:
    """{uid: [f32 logits row of each token]} filled as the router's
    engines sample (``ServeEngine.logits_sink``)."""
    rows = {}
    for fe in router.frontends:
        fe.engine.logits_sink = (
            lambda uid, row: rows.setdefault(uid, []).append(row.copy()))
    return rows


def _fleet_prefills(router) -> int:
    return sum(fe.engine.report.prefills for fe in router.frontends)


def _drive(router, prompts, max_new, uid0=0):
    for i, p in enumerate(prompts):
        router.submit(p, uid=uid0 + i, max_new_tokens=max_new)


def control_plane(cfg, device, requests=CP_REQUESTS):
    """Two tickets exported through ``core.lottery`` and registered in a
    ``TicketManager`` (fingerprints through ``smoke_decode``), a
    ``FleetRouter`` of two engines fleet-swapped from ticket A to B
    mid-stream (in-flight streams held to a no-swap run, later
    admissions on B's generation), one heartbeat failover of engine 0
    (every uid done, moved streams held to the never-failed run), a
    dense-slot engine against the paged one, and ``api.cli serve`` at
    full width.  Every prefill attends through kernel #8: its launches
    are held to one per layer per prefill."""
    import io
    import tempfile

    from repro_torch.api import cli
    from repro_torch.core import lottery
    from repro_torch.core.masks import lm_prunable
    from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import FleetRouter, Request, TicketManager

    L = cfg.n_layers
    t_phase = time.perf_counter()
    FA.flash_attention.launches = 0
    FA.flash_attention.launches_by_route.update(wgmma=0, simt=0)
    gen = torch.Generator(device=device).manual_seed(0)
    template = tfm.init_params(gen, cfg, device=device)
    mgr = TicketManager(cfg=cfg, params_template=template,
                        prunable=lm_prunable, prefill_fn=tfm.prefill,
                        decode_fn=tfm.decode_step, device=device)
    # the tickets share the template's initial weights (seed 0) and carry
    # their masks only: importing fills the weights from the template
    times = {}
    with tempfile.TemporaryDirectory(dir=OUT) as tdir:
        for name, seed in (("a", 1234), ("b", 4321)):
            t0 = time.perf_counter()
            lottery.export_ticket(f"{tdir}/{name}", None,
                                  ticket_masks(template, cfg, seed, device),
                                  meta={"arch": cfg.name})
            t1 = time.perf_counter()
            rec = mgr.register(name, f"{tdir}/{name}")
            sync(device)
            times[f"export_{name}_s"] = t1 - t0
            times[f"register_{name}_s"] = time.perf_counter() - t1
            print(f"ticket {name}: exported in {t1 - t0:.1f} s, registered "
                  f"in {times[f'register_{name}_s']:.1f} s, fingerprint "
                  f"{rec.fingerprint}")
    fp = {n: r.fingerprint for n, r in mgr.tickets.items()}
    require(fp["a"] != fp["b"], "the two tickets share a fingerprint")
    want_flash = 2 * L                       # one probe prefill each

    prng = np.random.default_rng(21)
    lengths = np.linspace(5, 300, requests).astype(int)
    prompts = [prng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in lengths]

    def fleet(**kw):
        return FleetRouter([mgr.make_engine("a", batch_slots=8, capacity=512,
                                            **kw) for _ in range(2)])

    # the no-swap, never-failed oracle, its logits kept for the failover
    oracle_router = fleet()
    oracle_logits = record_logits(oracle_router)
    _drive(oracle_router, prompts, CP_MAX_NEW)
    t0 = time.perf_counter()
    oracle_router.drain()
    sync(device)
    oracle_s = time.perf_counter() - t0
    oracle = {r.uid: list(r.tokens) for r in oracle_router.finished}
    n_pref = _fleet_prefills(oracle_router)
    want_flash += n_pref * L
    require(len(oracle) == requests, "the oracle fleet lost requests")
    orep = oracle_router.report
    del oracle_router

    # fleet swap A -> B mid-stream
    router = fleet()
    _drive(router, prompts, CP_MAX_NEW)
    router.pump(CP_SWAP_AFTER)
    in_flight = {rec.uid for rec in router.records.values()
                 if rec.req is not None and rec.req.status == "active"}
    t0 = time.perf_counter()
    ev = mgr.swap(router, "b")
    sync(device)
    swap_verify_s = time.perf_counter() - t0
    require(ev.accepted, f"fleet swap rejected: {ev.reason}")
    want_flash += len(ev.events) * L         # one probe prefill per engine
    post = [prng.integers(1, cfg.vocab_size, size=40).astype(np.int32)
            for _ in range(2)]
    _drive(router, post, CP_MAX_NEW, uid0=1000)
    router.drain()
    sync(device)
    n_pref = _fleet_prefills(router)
    want_flash += n_pref * L
    done = {r.uid: r for r in router.finished}
    require(len(done) == requests + len(post), "the swapped fleet lost "
            "requests")
    require(in_flight and all(done[u].generation == 0 for u in in_flight),
            f"in-flight requests {sorted(in_flight)} did not finish on "
            "generation 0")
    diverged = sorted(u for u in in_flight if done[u].tokens != oracle[u])
    print(f"fleet swap: {len(in_flight)} in flight at the swap, "
          f"{len(diverged)} diverged from the no-swap run {diverged}; "
          f"verify {swap_verify_s * 1e3:.1f} ms; post-swap generations "
          f"{[done[1000 + i].generation for i in range(len(post))]}")
    require(not diverged, "in-flight streams differ from the no-swap run")
    require(all(done[1000 + i].generation == ev.gid
                for i in range(len(post))),
            "post-swap admissions did not run on ticket B's generation")
    srep = router.report
    del router, done

    # the same swap with sampling: each request draws from its own
    # stream (ServeEngine._rng_for: the sample seed and its uid), so an
    # in-flight stream must not move either; a sampled stream holds more
    # than one token, so the check reaches past each request's first
    sampled = dict(temperature=CP_TEMPERATURE, sample_seed=CP_SAMPLE_SEED)
    oracle_router = fleet(**sampled)
    _drive(oracle_router, prompts, CP_MAX_NEW)
    oracle_router.drain()
    sync(device)
    want_flash += _fleet_prefills(oracle_router) * L
    s_oracle = {r.uid: list(r.tokens) for r in oracle_router.finished}
    require(len(s_oracle) == requests, "the sampled oracle fleet lost "
            "requests")
    del oracle_router
    router = fleet(**sampled)
    _drive(router, prompts, CP_MAX_NEW)
    router.pump(CP_SWAP_AFTER)
    s_in_flight = sorted(rec.uid for rec in router.records.values()
                         if rec.req is not None
                         and rec.req.status == "active")
    ev = mgr.swap(router, "b")
    require(ev.accepted, f"sampled fleet swap rejected: {ev.reason}")
    want_flash += len(ev.events) * L
    router.drain()
    sync(device)
    want_flash += _fleet_prefills(router) * L
    done = {r.uid: r for r in router.finished}
    require(len(done) == requests, "the sampled swapped fleet lost requests")
    require(s_in_flight and all(done[u].generation == 0 for u in s_in_flight),
            "sampled in-flight requests did not finish on generation 0")
    s_div = [u for u in s_in_flight if done[u].tokens != s_oracle[u]]
    s_distinct = {u: len(set(done[u].tokens)) for u in s_in_flight}
    print(f"sampled fleet swap (temperature {CP_TEMPERATURE}, sample_seed "
          f"{CP_SAMPLE_SEED}): {len(s_in_flight)} in flight, {len(s_div)} "
          f"diverged from the sampled no-swap run {s_div}; distinct tokens "
          f"per stream {s_distinct}")
    require(not s_div, "sampled in-flight streams differ from the sampled "
            "no-swap run")
    require(min(s_distinct.values()) >= 2, "a sampled in-flight stream "
            "repeats one token: the swap check would not discriminate")
    del router, done

    # heartbeat failover of engine 0 on an injected clock
    t = [0.0]
    with tempfile.TemporaryDirectory(dir=OUT) as hb_dir:
        monitor = HeartbeatMonitor(root=hb_dir, deadline_s=5.0,
                                   clock=lambda: t[0])
        router = FleetRouter(
            [mgr.make_engine("a", batch_slots=8, capacity=512,
                             clock=lambda: t[0]) for _ in range(2)],
            monitor=monitor)
        f_logits = record_logits(router)
        _drive(router, prompts, CP_MAX_NEW)
        router.pump(CP_SWAP_AFTER)               # both beat at t = 0
        f_before = {u: len(r.tokens) for u, r in router.records.items()}
        t[0] = 6.0                               # engine 0 wedges
        monitor.beat("engine1")
        router.pump(1)
        require(router.live == {1}, f"failover left {router.live} live")
        router.drain()
        sync(device)
    n_pref = _fleet_prefills(router)
    want_flash += n_pref * L
    moved = [r for r in router.records.values() if r.redispatches]
    require(len(router.finished) == requests
            and all(r.status == "done" for r in router.finished),
            "not every uid reached done after the failover")
    fdiv = sorted(r.uid for r in moved if r.tokens != oracle[r.uid])
    # greedy only: a re-admitted request draws from a fresh sampler
    # (repro's fleet promises no identical sampled continuation), so
    # this leg's streams may repeat one token; each moved stream's
    # logits (the re-admitted part prefilled again on engine 1) are
    # held to the never-failed run's as well
    f_distinct = {r.uid: len(set(r.tokens)) for r in moved}
    f_logit_err, f_worst_at = {}, {}
    for r in moved:
        got, want = f_logits.get(r.uid, []), oracle_logits.get(r.uid, [])
        require(len(got) == len(want) == len(r.tokens),
                f"moved stream {r.uid}: {len(got)} logits rows, "
                f"{len(want)} in the never-failed run, {len(r.tokens)} "
                "tokens")
        errs = [float(np.abs(a - b).max()) for a, b in zip(got, want)]
        scale = max(float(np.abs(b).max()) for b in want)
        f_logit_err[r.uid] = max(errs) / scale
        f_worst_at[r.uid] = int(np.argmax(errs))
    print(f"failover: {router.report.failovers} failover, {len(moved)} "
          f"moved ({sum(1 for r in moved if r.tokens)} with tokens "
          f"emitted), {len(fdiv)} diverged from the never-failed run {fdiv}; "
          f"distinct tokens per moved stream (greedy) {f_distinct}; "
          f"logits max_abs_err / max|logit| per moved stream {f_logit_err} "
          f"at tokens {f_worst_at}, re-admitted after "
          f"{ {r.uid: f_before[r.uid] for r in moved} } tokens (tol "
          f"{FAILOVER_LOGITS_TOL})")
    require(moved and not fdiv, "re-admitted streams differ from the "
            "never-failed fleet")
    require(max(f_logit_err.values()) <= FAILOVER_LOGITS_TOL,
            "a moved stream's logits differ from the never-failed run's "
            "beyond the bf16 gate")
    frep = router.report
    del router

    # dense-slot engine against the paged one, 8 requests each: every
    # other prompt, so that the longest (> 256 tokens) prefill at 511
    # rows on the dense engine (capacity 512) and at 512 on the paged one
    dense_prompts = prompts[1::2][:CP_DENSE_REQUESTS]
    step_ms = {}
    logits_err = 0.0
    for paged in (False, True):
        eng = mgr.make_engine("a", batch_slots=8, capacity=512, paged=paged)
        for i, p in enumerate(dense_prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=CP_MAX_NEW))
        ms = []
        while not eng.idle:
            before = eng.report.prefills
            ts = time.perf_counter()
            eng.step()
            sync(device)
            if eng.report.prefills == before:
                ms.append((time.perf_counter() - ts) * 1e3)
        want_flash += eng.report.prefills * L
        require(all(len(r.tokens) == CP_MAX_NEW for r in eng._finished),
                f"the {'paged' if paged else 'dense-slot'} engine lost "
                "tokens")
        step_ms["paged" if paged else "dense"] = sorted(ms)[len(ms) // 2]
        if paged:
            paged_eng = eng
        else:
            dense_eng = eng
    # each engine's prefill of one prompt, at its own bucket and cache
    # capacity: the same function at different row counts
    rec_a = mgr.tickets["a"]
    worst = None
    with torch.inference_mode():
        for p in dense_prompts:
            n = len(p)
            outs = []
            for eng in (dense_eng, paged_eng):
                S = eng._bucket(n)
                toks = np.zeros((1, S), np.int64)
                toks[0, :n] = p
                cap = S if eng.paged else eng.capacity
                lg, _ = tfm.prefill(
                    rec_a.params, cfg,
                    {"tokens": torch.as_tensor(toks, device=device)}, cap,
                    valid_len=torch.tensor([n], dtype=torch.int32,
                                           device=device),
                    plan=eng.plan)
                outs.append(lg[0, -1].float())
            want_flash += 2 * L
            e = (outs[0] - outs[1]).abs().max().item()
            scale = outs[1].abs().max().item()
            if worst is None or e / scale > worst[0] / worst[1]:
                worst = (e, scale, n, dense_eng._bucket(n),
                         paged_eng._bucket(n))
            logits_err = max(logits_err, e)
    e, scale, n, sd, sp = worst
    tol = 5e-2 * scale
    print(f"check dense-slot vs paged prefill logits (bf16, {L} layers, "
          f"prompt {n}, buckets {sd} vs {sp}): max_abs_err={e:.4e} "
          f"max|logit|={scale:.4e} tol={tol:.4e}")
    require(e <= tol, "dense-slot prefill disagrees with paged prefill")
    plan_a = paged_eng.plan
    del dense_eng, paged_eng, eng

    launches = FA.flash_attention.launches
    print(f"flash_attention launches {launches}, want {want_flash} "
          f"({L} per prefill)")
    require(launches == want_flash, "a prefill did not attend through "
            "kernel #8 once per layer")
    require_flash_routes(FA, want_flash, "control plane")

    # one prefill at a 512-token bucket under the profiler
    batch = {"tokens": torch.as_tensor(
        prng.integers(1, cfg.vocab_size, size=(1, 512)), device=device)}

    def pf():
        with torch.inference_mode():
            tfm.prefill(rec_a.params, cfg, batch, 512, plan=plan_a)
        sync(device)

    pf()
    prof = profile_call(pf)
    share = (prof["by_group_ms"].get("flash_attention", 0.0)
             / prof["device_ms"]) if "by_group_ms" in prof else None
    print(f"prefill profile (512 tokens): device {prof['device_ms']} ms, "
          f"flash share {share}")

    # the command line, in process, at full width
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = cli.main(["serve", "--arch", "llama3.2-3b", "--scale", "full",
                         "--engines", "2", "--requests", "4", "--json"])
    cli_s = time.perf_counter() - t0
    cli_out = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"cli serve: exit {code}, {json.dumps(cli_out)[:300]}")
    require(code == 0 and cli_out["event"] == "serve_fleet"
            and cli_out["requests"] == 4, "cli serve failed")

    summary = {
        "requests": requests, "max_new": CP_MAX_NEW, **times,
        "fingerprints": {k: list(v) for k, v in fp.items()},
        "swap_verify_ms": swap_verify_s * 1e3,
        "swap_in_flight": len(in_flight),
        "swap_sampled_in_flight": len(s_in_flight),
        "swap_sampled_distinct_tokens_min": min(s_distinct.values()),
        "swap_sampled_distinct_tokens": s_distinct,
        "failover_distinct_tokens": f_distinct,
        "failover_logits_rel_err": f_logit_err,
        "failover_logits_worst_token": f_worst_at,
        "oracle_drain_s": oracle_s,
        "fleet_ttft_p50_s": orep.ttft_p50, "fleet_ttft_p95_s": orep.ttft_p95,
        "fleet_tokens_per_s": orep.tokens_per_s,
        "swap_fleet_tokens_per_s": srep.tokens_per_s,
        "failover_moved": len(moved), "failover_tokens_per_s":
            frep.tokens_per_s,
        "decode_step_ms_p50": step_ms,
        "dense_vs_paged_prefill_max_abs_err": logits_err,
        "flash_launches": launches,
        "prefill_profile": {k: v for k, v in prof.items()
                            if k != "top_kernels"},
        "prefill_flash_share": share,
        "cli": cli_out, "cli_s": cli_s,
        "phase_s": time.perf_counter() - t_phase,
    }
    print("control plane: " + json.dumps(
        {k: summary[k] for k in ("swap_verify_ms",
                                 "swap_sampled_distinct_tokens_min",
                                 "failover_distinct_tokens",
                                 "failover_logits_rel_err",
                                 "fleet_ttft_p50_s",
                                 "fleet_ttft_p95_s", "fleet_tokens_per_s",
                                 "decode_step_ms_p50", "prefill_flash_share",
                                 "phase_s")}))
    return {"flash_attention": launches}, summary


ROUTED = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
          ("mlp", "up"), ("mlp", "gate"), ("mlp", "down"))


def grad_check(cfg, device):
    """One loss backward at full width and 2 layers on masked weights,
    through the ticket's plan and densely (plan=None, torch autograd):
    the masked gradients of every routed weight agree within 5e-2 of
    their scale (bf16), and the plan path's are exactly zero on dead
    tiles before masking."""
    import dataclasses

    from repro_torch._bridge import apply_masks, tree_map
    from repro_torch.data import SyntheticLM
    from repro_torch.models import transformer as tfm
    from repro_torch.train import lm_train_plan

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    gen = torch.Generator(device=device).manual_seed(3)
    params = tfm.init_params(gen, cfg2, device=device)
    masks = build_ticket(params, cfg2, device)
    params = apply_masks(params, masks)
    plan, _ = lm_train_plan(masks)
    b = SyntheticLM(256, 128, seed=0).batch(0, 8)
    batch = {k: torch.as_tensor(v, device=device) for k, v in b.items()}

    def grads(plan):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = tfm.loss_fn(p, cfg2, batch, plan=plan)
        layer = p["segments"][0][0]
        return loss, torch.autograd.grad(
            loss, [layer[g][k] for g, k in ROUTED])

    loss_p, g_plan = grads(plan)
    loss_d, g_dense = grads(None)
    worst = 0.0
    for (group, key), gp, gd in zip(ROUTED, g_plan, g_dense):
        m = masks["segments"][0][0][group][key]
        gpm, gdm = gp.float() * m, gd.float() * m
        err = (gpm - gdm).abs().max().item()
        scale = gdm.abs().max().item()
        worst = max(worst, err / max(scale, 1e-30))
        dead_clean = bool((gp[~m] == 0).all().item())
        print(f"check grad {group}.{key} {tuple(gp.shape)} plan vs dense "
              f"max_abs_err={err:.4e} max|grad|={scale:.4e} "
              f"tol={5e-2 * scale:.4e} dead_tiles_zero={dead_clean}")
        require(bool(torch.isfinite(gp).all().item()), "non-finite grad")
        require(err <= 5e-2 * scale, f"plan grad of {group}.{key} disagrees "
                "with the dense grad")
        require(dead_clean, f"plan grad of {group}.{key} is not zero on "
                "dead tiles")
    print(f"check loss plan {loss_p.item():.6f} dense {loss_d.item():.6f}")
    return {"grad_rel_err_max": worst, "loss_plan": loss_p.item(),
            "loss_dense": loss_d.item()}


def retrain(cfg, device, steps: int = 4):
    """``LMAdapter.make_trainer(params, masks).run`` at full width and
    depth: finite losses and parameters, pruned coordinates exactly zero,
    ``sent_fraction`` equal to the mask share counted on the host, and
    the launch counts a step must make.  Steps run one ``run(1)`` at a
    time so that each is timed on the host clock (``run`` synchronises
    the card)."""
    from repro_torch._bridge import tree_leaves
    from repro_torch.api import LMAdapter
    from repro_torch.kernels import bsmm as B
    from repro_torch.models import transformer as tfm

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    adapter = LMAdapter(cfg, batch_size=8, seq_len=128, device=device)
    params = adapter.init_params(
        torch.Generator(device=device).manual_seed(0))
    masks = build_ticket(params, cfg, device)
    trainer = adapter.make_trainer(params, masks, learning_rate=1e-4)
    del params
    sync(device)
    setup_s = time.perf_counter() - t0

    # live prunable coordinates plus every unmasked one, over all
    total = sum(p.numel() for p in tree_leaves(trainer.state.params))
    pruned = sum(p.numel() - int(m.count_nonzero().item())
                 for p, m in _mask_pairs(trainer.state.params, masks))
    want_sent = (total - pruned) / total

    reset_bsmm_routes(B)
    losses, sent, step_s = [], [], []
    for _ in range(steps):
        ts = time.perf_counter()
        m = trainer.run(1)
        step_s.append(time.perf_counter() - ts)
        losses.append(m["loss"])
        sent.append(m["sent_fraction"])
    launches = {name: getattr(B, name).launches for name in BSMM_ROUTED}
    routes = bsmm_routes(B)
    peak = torch.cuda.max_memory_allocated() if on_card else None

    L = cfg.n_layers
    remat = tfm.remat_enabled()
    print(f"retrain: remat={remat} layers={L} losses={losses} "
          f"sent_fraction={sent[-1]} (host {want_sent})")
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    require(all(abs(s - want_sent) < 1e-12 for s in sent),
            f"sent_fraction {sent} != host count {want_sent}")
    want = require_llama_steps(B, launches, routes, masks, L, steps,
                               "retraining")
    finite = all(bool(torch.isfinite(p).all().item())
                 for p in tree_leaves(trainer.state.params))
    require(finite, "a parameter is non-finite after retraining")
    for p, m in _mask_pairs(trainer.state.params, masks):
        require(not bool(((p != 0) & ~m).any().item()),
                "a pruned coordinate is non-zero after retraining")

    tokens = 8 * 128
    mid = sorted(step_s[1:])
    step_med = mid[len(mid) // 2]
    profile = profile_step(trainer) if on_card else None
    if profile and profile["device_ms"] != "not measured":
        dx_ms = profile["by_group_ms"].get("bsmm_dx", 0.0)
        print(f"retrain profile: bsmm_dx {dx_ms} ms of "
              f"{profile['device_ms']} device ms")
        require(dx_ms > 0, "the profiled retrain step shows no bsmm_dx "
                "kernel time")
    return launches, {
        "setup_s": setup_s, "steps": steps, "remat": remat,
        "step_s": step_s, "step_s_median_2_to_4": step_med,
        "tokens_per_s": tokens / step_med, "losses": losses,
        "sent_fraction": sent[-1], "sent_fraction_host": want_sent,
        "max_memory_allocated_bytes": peak,
        "launches_per_step": want, "bsmm_routes": routes,
        "live_tiles": adapter.last_plan_stats
        .live_tiles, "total_tiles": adapter.last_plan_stats.total_tiles,
        "profile": profile}


def require_llama_steps(B, launches, routes, masks, L, steps,
                        where) -> dict:
    """Hold ``steps`` llama train steps' bsmm launches (by wrapper, and
    ``routes`` as ``bsmm_routes`` gives them) to the model: every routed
    product at 8 x 128 rows in bf16 on the wgmma kernels, cut where its
    plan says; r forwards of the six plain projections, r + 1 of the
    gate (the backward recomputes its pre-activation), one dx and one
    dw of each of the seven, a layer (r = 2 with remat).  Returns the
    launches a step must make."""
    from repro_torch.models import transformer as tfm

    r = 2 if tfm.remat_enabled() else 1
    want = {"bsmm": 6 * r * L, "bsmm_epilogue": (r + 1) * L,
            "bsmm_dx": 7 * L, "bsmm_dw": 7 * L}
    plans = ticket_plans(B, masks)
    M = 8 * 128
    want_cut = {
        "bsmm": steps * r * L * sum(is_cut(plans[k], "fwd", M)
                                    for k in PLAIN_PROJECTIONS),
        "bsmm_epilogue": steps * (r + 1) * L * is_cut(plans["gate"], "fwd",
                                                      M),
        "bsmm_dx": steps * L * sum(is_cut(p, "dx", M)
                                   for p in plans.values()),
        "bsmm_dw": steps * L * sum(is_cut(p, "dw", M)
                                   for p in plans.values())}
    print(f"{where}: launches {launches}, per step want {want}")
    require(all(launches[k] == steps * v for k, v in want.items()),
            f"{where}: launch counts {launches} do not match {steps} steps "
            f"of {want}")
    for name in BSMM_ROUTED:
        want_routes = {k: launches[name] * (k == "wgmma")
                       for k in routes[name]["launches_by_route"]}
        require(routes[name]["launches_by_route"] == want_routes
                and routes[name]["split_launches"] == want_cut[name],
                f"{name} routes {routes[name]} in {where}, want "
                f"{want_routes} and {want_cut[name]} split launches")
    return want


def counts_now(B, names=BSMM_ROUTED) -> tuple:
    """(launches by wrapper, ``bsmm_routes``) as they stand."""
    return ({n: getattr(B, n).launches for n in names},
            bsmm_routes(B, names))


def counts_since(B, before, names=BSMM_ROUTED) -> tuple:
    """``counts_now`` less an earlier reading of it."""
    (l0, r0), (l1, r1) = before, counts_now(B, names)
    return ({n: l1[n] - l0[n] for n in names},
            {n: {"launches_by_route": {
                k: v - r0[n]["launches_by_route"][k]
                for k, v in r1[n]["launches_by_route"].items()},
                "split_launches": r1[n]["split_launches"]
                - r0[n]["split_launches"]} for n in names})


def _kernel_group(name: str) -> str:
    """A profiled CUDA kernel's group: the bsmm kernels by role (dx is
    ``bsmm_dx_wgmma_kernel``, or the forward template with its last
    template argument, TRANS, true; the weight-streaming kernel and
    ``bsmm_batched_wgmma_kernel`` run the expert-batched forward, the
    ``bsmm_batched_{dx,dw}_*`` kernels its backward), paged attention
    (with its combine kernel),
    flash attention, the LTP product's kernels (with the split-K
    reduction), cuBLAS products, PyTorch's elementwise kernels, the
    rest."""
    import re

    if "bsmm_batched_dx" in name:
        return "bsmm_batched_dx"
    if "bsmm_batched_dw" in name:
        return "bsmm_batched_dw"
    if "bsmm_stream" in name or "bsmm_batched_wgmma" in name:
        return "bsmm_batched"
    if "bsmm_dx" in name:
        return "bsmm_dx"
    if "bsmm_dw" in name:
        return "bsmm_dw"
    if "bsmm2d" in name:
        return "bsmm_forward"
    if "paged_attention" in name:
        return "paged_attention"
    if "flash_attention" in name:
        return "flash_attention"
    if "masked" in name:
        return "masked_matmul"
    m = re.search(r"bsmm_\w+<([^>]*)>", name)
    if m:
        return "bsmm_dx" if m.group(1).replace(" ", "").endswith("true") \
            else "bsmm_forward"
    if "gemm" in name or "cutlass" in name or "nvjet" in name:
        return "library_gemm"
    if "elementwise" in name:
        return "elementwise"
    return "other"


def profile_step(trainer) -> dict:
    """One more retrain step under ``torch.profiler`` (after the counted
    run); see ``profile_call``."""
    return profile_call(lambda: trainer.run(1))


def profile_call(fn) -> dict:
    """``fn()`` under ``torch.profiler``, tracing the device alone (host
    ops are never read, and a step of ~10^6 small ones, as xlstm's token
    loops, costs minutes of trace processing): device time by kernel
    name, the call's host-clock time (``fn`` must end synchronised) and
    the device's busy share (kernel time over it).  A measurement, not a
    gate: where the profiler shows no device time it says so."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - ts) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms == 0:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    groups = {}
    for name, ms, _ in rows:
        groups[_kernel_group(name)] = groups.get(_kernel_group(name),
                                                 0.0) + ms
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "by_group_ms": groups,
            "top_kernels": [{"name": n[:120], "ms": ms, "calls": c}
                            for n, ms, c in rows[:25]]}


def _mask_pairs(params, masks):
    """(parameter, bool mask) for every masked routed weight."""
    for seg_p, seg_m in zip(params["segments"], masks["segments"]):
        for pos_p, pos_m in zip(seg_p, seg_m):
            for group, key in ROUTED:
                yield pos_p[group][key], pos_m[group][key]


# ---------------------------------------------------------------------------
# the LM pruning program: llama3.2-3b's dense-full recipe through prune,
# int8 QAT and export, then the ticket's deployable form
# ---------------------------------------------------------------------------
LM_LAYERS = 4           # llama3.2-3b's 28 layers cut: the host-side prune
LM_STEPS = 4            # retrain steps a stage (dense-full: 200-300)
# the gate, in nats of held-out cross-entropy: after 4 retrain steps on
# synthetic tokens the score (-CE, ~-10.7) moved 0.14-0.25 under a
# 15-20 % prune on an H100, and PruneConfig's default 0.0 refused every
# prune stage (accepting only the quantize stage); 0.5 lets the program
# prune, as CNN_TOLERANCE does for vgg11
LM_TOLERANCE = 0.5
LM_QAT_STEPS = 4        # the timed plain and QAT legs on the ticket
LM_BATCH, LM_SEQ = 8, 128
FAKE_BITS = 8


def lm_session_config(layers=LM_LAYERS):
    """llama3.2-3b at its published widths, ``layers`` deep, registered
    under its own name so that the command line can build it."""
    import dataclasses

    from repro_torch.configs import get_arch, register
    cfg = get_arch("llama3.2-3b")
    return register(dataclasses.replace(
        cfg, n_layers=layers, name=f"{cfg.name}-{layers}l"))


def _bf16_ulp(t):
    """One bf16 ulp at each |t| (the spacing of its binade)."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def check_fake_pass(params, masks, prunable):
    """The QAT stage's fake pass on the card: every masked weight of the
    fake-quantized tree exactly 0, each live weight within scale / 2
    plus one bf16 ulp of its source.  Returns the worst excess over
    scale / 2 in ulps."""
    from repro_torch.core.masks import tree_flatten_with_path
    from repro_torch.core.quantize import fake_quantize_tree, quantize

    fake = dict(tree_flatten_with_path(
        fake_quantize_tree(params, prunable, FAKE_BITS)))
    mask = dict(tree_flatten_with_path(masks))
    worst, leaves = 0.0, 0
    with torch.no_grad():
        for path, w in tree_flatten_with_path(params):
            m = mask.get(path)
            if m is None:
                continue
            f = fake[path]
            require(f.device == w.device and f.dtype == w.dtype,
                    f"fake pass of {path} left the card or its dtype")
            dead = m.expand_as(w) == 0
            require(not bool(f[dead].any().item()),
                    f"a masked weight of {path} is non-zero after the fake "
                    "pass")
            half = quantize(w, FAKE_BITS).scale / 2
            ulp = _bf16_ulp(torch.maximum(w.abs(), f.abs()))
            err = (f.float() - w.float()).abs()
            excess = ((err - half) / ulp).max().item()
            require(bool((err <= half + ulp).all().item()),
                    f"a live weight of {path} moved more than scale/2 + one "
                    f"ulp in the fake pass ({excess:.3f} ulp over)")
            worst = max(worst, excess)
            leaves += 1
            del f, dead, half, ulp, err
    print(f"fake pass on the card: {leaves} leaves, masked weights 0, "
          f"live within scale/2 + 1 ulp (worst {worst:.3f} ulp over "
          "scale/2)")
    return {"leaves": leaves, "worst_ulp_over_half_scale": worst}


def check_packing(params, masks, cfg, device) -> dict:
    """``pack_lm_params`` on a ticket: when a column packs away, the
    packed model's dense logits against the pruned model's block-sparse
    ones on one batch, within 1e-2 of their scale (bf16); when none
    does, the input returned unchanged."""
    from repro_torch.core.packing import pack_lm_params
    from repro_torch.data import SyntheticLM
    from repro_torch.models import transformer as tfm
    from repro_torch.train import lm_train_plan

    packed, cfg_p = pack_lm_params(params, masks, cfg)
    out = {"d_ff": cfg.d_ff, "packed_d_ff": cfg_p.d_ff}
    if cfg_p.d_ff == cfg.d_ff:
        print(f"packed FFN: no column of d_ff {cfg.d_ff} packs away")
        require(packed is params and cfg_p is cfg, "pack_lm_params changed "
                "a ticket with nothing to pack")
        return out
    b = SyntheticLM(256, LM_SEQ, seed=0).batch(20_000, LM_BATCH)
    batch = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
    plan, _ = lm_train_plan(masks)
    with torch.inference_mode():
        want, _ = tfm.forward(params, cfg, batch, plan=plan)
        got, _ = tfm.forward(packed, cfg_p, batch)
    e = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    out.update(max_abs_err=e, scale=scale)
    print(f"packed FFN {cfg.d_ff} -> {cfg_p.d_ff}: dense logits vs the "
          f"pruned model's block-sparse ones max_abs_err={e:.4e} "
          f"max|logit|={scale:.4e} tol={1e-2 * scale:.4e}")
    require(e <= 1e-2 * scale, "the packed model's logits disagree with "
            "the pruned model's")
    return out


def timed_steps(trainer, steps, on_card):
    """``steps`` synchronised ``run(1)`` calls: (losses, step seconds,
    median of steps 2-4, peak bytes allocated)."""
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(steps):
        ts = time.perf_counter()
        losses.append(trainer.run(1)["loss"])
        step_s.append(time.perf_counter() - ts)
    mid = sorted(step_s[1:])
    peak = torch.cuda.max_memory_allocated() if on_card else None
    return losses, step_s, mid[len(mid) // 2], peak


def lm_session(device, layers=LM_LAYERS, steps=LM_STEPS):
    """An LM pruning program through the entry points a user calls:
    ``make_adapter`` on llama3.2-3b at its published widths (``layers``
    deep) and ``PruningSession(...).run()`` on the ``dense-full`` recipe
    cut to one round of ``steps`` retrain steps a prune stage; every
    event printed with its wall time, the quantize stage required.
    Then on the ticket: a plain and an int8 QAT retrain leg (timed, peak
    memory, the QAT leg's launches and routes held to the model), the
    fake pass checked on the card, the deployable form (int8
    ``quantize_tree`` and its bytes, the hardware report's, the packed
    FFN width and, when a column packs away, the packed model's dense
    logits against the pruned model's block-sparse ones), the ticket's
    export, and ``api.cli finetune`` (QAT, from the ticket's bits) and
    ``api.cli report`` on it in process."""
    import dataclasses
    import io
    import tempfile

    from repro_torch._bridge import tree_leaves
    from repro_torch.api import PruningSession, cli, get_recipe, make_adapter
    from repro_torch.configs import PruneConfig
    from repro_torch.core import lottery
    from repro_torch.core.quantize import quantize_tree, tree_bytes
    from repro_torch.kernels import bsmm as B

    on_card = torch.device(device).type == "cuda"
    cfg = lm_session_config(layers)
    adapter = make_adapter(cfg, device=device, steps=steps,
                           batch_size=LM_BATCH, seq_len=LM_SEQ)
    family = get_recipe("dense-full").with_retrain_steps(steps)
    recipe = family.replace(stages=tuple(
        dataclasses.replace(st, max_rounds=1) if st.kind == "prune" else st
        for st in family.stages))
    events, event_t = [], []

    def on_event(e):
        sync(device)
        events.append(e)
        event_t.append(time.perf_counter())

    t0 = time.perf_counter()
    sess = PruningSession(adapter, PruneConfig(
        accuracy_tolerance=LM_TOLERANCE), recipe=recipe,
        callbacks=[on_event])
    res = sess.run()
    sync(device)
    session_s = time.perf_counter() - t0
    round_s = [b - a for a, b in zip([t0] + event_t, event_t)]
    for e, dt in zip(events, round_s):
        print(f"lm event {e.iteration} [{e.stage}] {e.kind} {e.granularity}: "
              f"{'accepted' if e.accepted else 'refused'} sparsity "
              f"{e.sparsity_before:.4f} -> {e.sparsity_after:.4f} score "
              f"{e.accuracy:.4f} ({dt:.2f} s)")
    quant = [e for e in events if e.kind == "quantize"]
    require(len(quant) == 1, "the session's quantize stage did not run")
    require(quant[0].accepted and sess.quantize_bits == FAKE_BITS,
            f"the quantize stage was refused (score {quant[0].accuracy}, "
            f"gate {LM_TOLERANCE})")

    # the plain and the QAT retrain legs on the ticket; the QAT leg's
    # launches and routes held to the model
    legs = {}
    for bits in (None, FAKE_BITS):
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        trainer = adapter.make_trainer(res.params, res.masks,
                                       learning_rate=1e-4,
                                       quantize_bits=bits)
        sync(device)
        before = counts_now(B)
        losses, step_s, med, peak = timed_steps(trainer, LM_QAT_STEPS,
                                                on_card)
        launches, routes = counts_since(B, before)
        legs["qat" if bits else "plain"] = {
            "losses": losses, "step_s": step_s,
            "step_s_median_2_to_4": med,
            "tokens_per_s": LM_BATCH * LM_SEQ / med,
            "max_memory_allocated_bytes": peak}
        require(all(np.isfinite(losses)), f"non-finite loss {losses}")
        if bits:
            want = require_llama_steps(B, launches, routes, res.masks,
                                       layers, LM_QAT_STEPS, "the QAT leg")
            legs["qat"].update(launches=launches, launches_per_step=want,
                               bsmm_routes=routes)
            tuned = trainer.state.params
        del trainer
    for p, m in _mask_pairs(tuned, res.masks):
        require(not bool(((p != 0) & (m == 0)).any().item()),
                "a pruned coordinate is non-zero after the QAT leg")
    print("lm QAT legs: " + json.dumps(
        {k: {kk: vv for kk, vv in v.items() if kk != "bsmm_routes"}
         for k, v in legs.items()}))
    fake = check_fake_pass(tuned, res.masks, adapter.prunable)

    # the deployable form
    ts = time.perf_counter()
    qtree = quantize_tree(tuned, adapter.prunable, FAKE_BITS)
    int8_bytes, dense_bytes = tree_bytes(qtree), tree_bytes(tuned)
    del qtree
    weight_bytes = sess.hardware_report().weight_bytes()
    pack = check_packing(tuned, res.masks, cfg, device)
    deploy_s = time.perf_counter() - ts
    print(f"lm deployable form ({deploy_s:.1f} s): int8 tree {int8_bytes} "
          f"bytes, dense {dense_bytes}; hardware report {weight_bytes}; "
          f"{pack}")

    # the ticket out, then the command line on it
    cli_out = {}
    with tempfile.TemporaryDirectory(dir=OUT) as tdir:
        ts = time.perf_counter()
        sess.export_ticket(tdir)
        export_s = time.perf_counter() - ts
        meta = lottery.ticket_meta(tdir)
        print(f"lm ticket exported in {export_s:.1f} s, meta {meta}")
        require(meta.get("quantize_bits") == FAKE_BITS,
                f"ticket meta {meta}")
        for verb, extra in (("finetune", ["--steps", "2"]), ("report", [])):
            out = io.StringIO()
            ts = time.perf_counter()
            with contextlib.redirect_stdout(out):
                code = cli.main([verb, "--arch", cfg.name, "--scale", "full",
                                 "--device", str(device), "--ticket", tdir,
                                 "--json", *extra])
            row = json.loads(out.getvalue().strip().splitlines()[-1])
            cli_out[verb] = {**row, "exit": code,
                             "s": time.perf_counter() - ts}
            print(f"cli {verb} ({cli_out[verb]['s']:.1f} s): exit {code}, "
                  f"{json.dumps(row)[:300]}")
            require(code == 0 and row["event"] == verb
                    and row["quantize_bits"] == FAKE_BITS,
                    f"cli {verb} on the QAT ticket failed")
    require(np.isfinite(cli_out["finetune"]["loss"]),
            "non-finite finetune loss")
    require(all(bool(torch.isfinite(t).all().item())
                for t in tree_leaves(tuned)), "a non-finite tuned weight")
    return {
        "config": cfg.name, "n_layers": layers, "steps_per_stage": steps,
        "recipe": recipe.name, "accuracy_tolerance": LM_TOLERANCE,
        "events": [{"stage": e.stage, "kind": e.kind,
                    "granularity": e.granularity, "accepted": e.accepted,
                    "sparsity": e.sparsity_after, "score": e.accuracy}
                   for e in events],
        "round_s": round_s, "session_s": session_s,
        "sparsity": res.sparsity, "quantize_bits": sess.quantize_bits,
        "legs": legs, "fake_pass": fake,
        "int8_tree_bytes": int8_bytes, "dense_tree_bytes": dense_bytes,
        "hardware_weight_bytes": weight_bytes, "packing": pack,
        "deployable_s": deploy_s, "export_s": export_s, "cli": cli_out}


# ---------------------------------------------------------------------------
# deepseek-v3: the expert-batched bsmm and the serving phase
# ---------------------------------------------------------------------------
EXPERT_SHAPES = ((7168, 2048), (2048, 7168))    # up/gate, down
# the 2-D bsmm shapes of deepseek-v3's dense FFNs (up/gate, down) and
# shared expert, at its decode rows, the 17-token prompt, the longest
# and the retrain's 8 x 128 tokens
DEEPSEEK_BSMM_SHAPES = ((7168, 18432), (18432, 7168)) + EXPERT_SHAPES
DEEPSEEK_BSMM_ROWS = (8, 17, 300) + GRAD_ROWS[:1]     # and the retrain's
EXPERT_ROWS = (8, 16, 20)     # rows per expert: decode, prefill, ragged
EXPERTS = 256


def check_bsmm_batched(B, E=EXPERTS, shapes=EXPERT_SHAPES, rows=EXPERT_ROWS,
                       timed=(8, 16), seed=3):
    """The expert-batched bsmm against its plain version at ``shapes``
    over ``E`` experts under one shared plan (deepseek-v3's by default:
    E = 256, M = 8, 16 and a ragged 20 rows an expert), bf16 and f32,
    each call held to the route and split count its rule gives and two
    calls bitwise equal; timed in bf16 at the rows of ``timed`` beside
    torch.bmm on the dense masked experts."""
    rng = np.random.default_rng(seed)
    err = 0.0
    times = []
    for dtype in (torch.bfloat16, torch.float32):
        for K, N in shapes:
            bm = random_bitmap(rng, K, N)
            plan = B.make_tile_plan(np.kron(bm, np.ones((128, 128), bool)))
            g = torch.Generator(device="cuda").manual_seed(K + 3 * N)
            w = torch.randn(E, K, N, device="cuda", generator=g,
                            dtype=dtype) / K ** 0.5
            for M in rows:
                a = torch.randn(E, M, K, device="cuda", generator=g,
                                dtype=dtype)
                route, S = plan.route_and_splits("fwd", M, dtype, E)
                got = held(B.bsmm_batched, route, S, a, w, plan)
                require(torch.equal(got, B.bsmm_batched(a, w, plan)),
                        f"two bsmm_batched calls differ at E={E} M={M} K={K} "
                        f"N={N}")
                want = B.bsmm_batched_plain(a, w, plan)
                torch.cuda.synchronize()
                e = (got.float() - want.float()).abs().max().item()
                tol = tolerance(dtype, want)
                print(f"check bsmm_batched {str(dtype)[6:]} E={E} M={M} "
                      f"K={K} N={N} {route} splits={S} max_abs_err={e:.3e} "
                      f"tol={tol:.3e}")
                require(torch.isfinite(got).all().item(),
                        "bsmm_batched non-finite")
                require(e <= tol, f"bsmm_batched disagrees with its plain "
                        f"version at E={E} M={M} K={K} N={N} {dtype}")
                err = max(err, e)
                if dtype == torch.bfloat16 and M in timed:
                    times.append(time_bsmm_batched(B, a, w, bm, plan, M, K,
                                                   N))
                del got, want, a
            del w
            torch.cuda.empty_cache()
    return err, times


def time_bsmm_batched(B, a, w, bm, plan, M, K, N):
    """Kernel, plain and torch.bmm (dense masked experts) times; one
    call reads gigabytes of weights, so nothing stays in the L2."""
    E = a.shape[0]
    row = {"E": E, "M": M, "K": K, "N": N, "dtype": "bfloat16",
           "live_tiles": plan.live_tiles, "total_tiles": plan.total_tiles}
    row["route"], row["splits"] = plan.route_and_splits("fwd", M, a.dtype, E)
    row["ms"] = time_ms(lambda i: B.bsmm_batched(a, w, plan), iters=10)
    row["plain_ms"] = time_ms(lambda i: B.bsmm_batched_plain(a, w, plan),
                              iters=3, graph=False)
    dense = w * torch.as_tensor(np.kron(bm, np.ones((128, 128))),
                                dtype=w.dtype, device=w.device)
    row["library_ms"] = time_ms(lambda i: torch.bmm(a, dense), iters=10)
    del dense
    row["bound_ms"], row["bound_by"] = bsmm_bound_ms(
        M, K, N, plan, 2, "bfloat16", experts=E)
    print("time bsmm_batched " + json.dumps(row))
    return row


def build_expert_ticket(params, device):
    """deepseek-v3's ticket: one seeded ~25 %-live 128x128 tile bitmap
    per routed projection (dense-FFN, expert and shared-expert up, gate
    and down), shared by every layer of a segment and every expert as
    an expanded view, like ``build_ticket``.  MLA projections and the
    router stay unpruned (the reference plans neither)."""
    rng = np.random.default_rng(4321)

    def bitmap(shape):
        K, N = shape[-2:]
        bm = torch.as_tensor(random_bitmap(rng, K, N), device=device)
        return bm.repeat_interleave(128, 0).repeat_interleave(128, 1) \
            .expand(shape)

    def group(p):
        m = {k: bitmap(p[k].shape) for k in ("up", "gate", "down")}
        if "shared" in p:
            m["shared"] = group(p["shared"])
        return m

    return {"segments": [[{g: group(p[g]) for g in ("mlp", "moe") if g in p}
                          for p in pos_trees]
                         for pos_trees in params["segments"]]}


def serve_deepseek(cfg, device):
    """Serve 8 requests through ``ServeEngine`` on deepseek-v3 at full
    width, 4 layers (3 dense, 1 MoE of 256 experts), a crossbar ticket
    shared by every layer and expert; check finishing, finite logits,
    the launch counts the model implies and plan-vs-dense prefill."""
    from repro_torch._bridge import tree_leaves
    from repro_torch.core.masks import apply_masks_
    from repro_torch.kernels import bsmm as B
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import Request, ServeEngine

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = tfm.init_params(gen, cfg, device=device)
    masks = build_expert_ticket(params, device)
    apply_masks_(params, masks)            # full-width copies do not fit
    sync(device)
    setup_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    eng = ServeEngine(params=params, cfg=cfg, masks=masks, batch_slots=8,
                      capacity=512, device=device)
    nonfinite = [0]
    sample = eng._sample_row

    def checked(row, rng):
        nonfinite[0] += int((~np.isfinite(row)).sum())
        return sample(row, rng)

    eng._sample_row = checked
    prng = np.random.default_rng(8)
    lengths = (5, 17, 64, 127, 128, 129, 200, 300)
    budgets = [16 + (i * 16) // 7 for i in range(len(lengths))]   # 16..32
    reqs = [Request(uid=i, prompt=prng.integers(1, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new_tokens=budgets[i])
            for i, n in enumerate(lengths)]
    for r in reqs:
        eng.submit(r)

    counters = ((B.bsmm, "launches"), (B.bsmm_epilogue, "launches"),
                (PA.paged_attention, "launches"),
                (PA.paged_attention, "fused_launches"),
                (FA.flash_attention, "launches"))
    for f, attr in counters:
        setattr(f, attr, 0)
    reset_bsmm_routes(B, ("bsmm_batched",))
    FA.flash_attention.launches_by_route.update(wgmma=0, simt=0)
    PA.paged_attention.fused_launches_by_route.update(wgmma=0, simt=0)
    step_ms = []
    t0 = time.perf_counter()
    while not eng.idle:
        before = eng.report.prefills
        ts = time.perf_counter()
        eng.step()
        sync(device)
        if eng.report.prefills == before:       # a decode-only tick
            step_ms.append((time.perf_counter() - ts) * 1e3)
    serve_s = time.perf_counter() - t0
    launches = {"bsmm": B.bsmm.launches,
                "bsmm_epilogue": B.bsmm_epilogue.launches,
                "bsmm_batched": B.bsmm_batched.launches,
                "paged_attention": PA.paged_attention.launches,
                "paged_attention_fused_v": PA.paged_attention.fused_launches,
                "flash_attention": FA.flash_attention.launches}
    rep = eng.report
    require(all(r.done and len(r.tokens) == r.max_new_tokens for r in reqs),
            "not every deepseek request finished")
    require(nonfinite[0] == 0, f"{nonfinite[0]} non-finite logits")
    # per pass: a dense layer runs up and down through bsmm and the gate
    # through the epilogue; a MoE layer runs its three expert products
    # batched and its shared expert like a dense FFN; MLA runs dense
    n_moe = sum(1 for i in range(cfg.n_layers)
                if tfm.layer_signature(cfg, i)[1])
    n_dense = cfg.n_layers - n_moe
    passes = rep.prefills + rep.decode_steps
    want = {"bsmm": passes * 2 * (n_dense + n_moe),
            "bsmm_epilogue": passes * (n_dense + n_moe),
            "bsmm_batched": passes * 3 * n_moe,
            "paged_attention": 0,
            "paged_attention_fused_v": rep.decode_steps * cfg.n_layers,
            "flash_attention": rep.prefills * cfg.n_layers}
    print(f"deepseek launches {launches}, want {want} ({rep.prefills} "
          f"prefills, {rep.decode_steps} decode steps, {n_dense} dense and "
          f"{n_moe} MoE layers)")
    require(launches == want, "deepseek launch counts do not match the model")
    require_flash_routes(FA, want["flash_attention"], "deepseek serving")
    fused_routes = dict(PA.paged_attention.fused_launches_by_route)
    print(f"deepseek serving: fused-V launches by route {fused_routes}")
    require(fused_routes == {"wgmma": want["paged_attention_fused_v"],
                             "simt": 0},
            "a deepseek decode step's fused-V attention left the wgmma "
            "kernel")
    # decode and prefill give each expert at most 32 rows of 256 experts:
    # every batched forward streams its weights, none cut
    batched_routes = bsmm_routes(B, ("bsmm_batched",))["bsmm_batched"]
    print(f"deepseek serving: batched forward routes {batched_routes}")
    require(batched_routes == {
        "launches_by_route": {k: want["bsmm_batched"] * (k == "stream")
                              for k in B.bsmm_batched.launches_by_route},
        "split_launches": 0},
        "a deepseek serving pass's batched forward left the stream kernel")

    # block-sparse prefill through the plan vs dense prefill on the
    # masked weights, at one exact-length prompt
    n = 129
    with torch.inference_mode():
        batch = {"tokens": torch.as_tensor(reqs[5].prompt[None].astype(
            np.int64), device=device)}
        got, _ = tfm.prefill(params, cfg, batch, n, plan=eng.plan)
        want_l, _ = tfm.prefill(params, cfg, batch, n)
    diff = (got.float() - want_l.float()).abs().max().item()
    scale = want_l.float().abs().max().item()
    tol = 5e-2 * scale
    same_argmax = bool((got.argmax(-1) == want_l.argmax(-1)).all().item())
    print(f"check deepseek plan prefill vs dense masked prefill ({cfg.dtype},"
          f" {cfg.n_layers} layers, exact length {n}): max_abs_err={diff:.4e} "
          f"max|logit|={scale:.4e} tol={tol:.4e} same_argmax={same_argmax}")
    require(bool(torch.isfinite(got).all().item()), "plan prefill non-finite")
    require(diff <= tol, "deepseek plan prefill disagrees with dense prefill")

    step_ms.sort()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    profile = profile_decode(eng, cfg, device) if on_card else None
    summary = {
        "config": cfg.name, "n_layers": cfg.n_layers, "parameters": n_params,
        "setup_s": setup_s, "serve_s": serve_s,
        "decode_only_steps": len(step_ms),
        "decode_step_ms_p50": step_ms[len(step_ms) // 2] if step_ms else None,
        "decode_step_ms_min": step_ms[0] if step_ms else None,
        "tokens_per_s": rep.tokens_per_s,
        "ttft_p50_s": rep.ttft_p50, "ttft_p95_s": rep.ttft_p95,
        "max_memory_allocated_bytes": peak,
        "skipped_tile_fraction": rep.skipped_tile_fraction,
        "launches": launches, "launches_want": want,
        "fused_launches_by_route": fused_routes,
        "bsmm_batched_routes": batched_routes,
        "prefill_plan_vs_dense_max_abs_err": diff,
        "prefill_plan_vs_dense_tol": tol,
        "decode_profile": profile,
        "report": rep.__dict__,
    }
    print("deepseek serve: " + json.dumps(
        {k: summary[k] for k in ("decode_step_ms_p50", "decode_step_ms_min",
                                 "tokens_per_s", "ttft_p50_s", "ttft_p95_s",
                                 "max_memory_allocated_bytes",
                                 "skipped_tile_fraction")}))
    return launches, summary


def profile_decode(eng, cfg, device, label="deepseek", frames=None) -> dict:
    """One decode-only tick with 8 busy slots under ``torch.profiler``:
    8 more requests are prefilled first (with ``frames(uid)`` as their
    encoder frames where given), then the next tick is profiled
    (``profile_call``); the engine then runs to the end."""
    from repro_torch.serve import Request

    prng = np.random.default_rng(9)
    for i in range(8):
        eng.submit(Request(uid=200 + i, prompt=prng.integers(
            1, cfg.vocab_size, size=64).astype(np.int32), max_new_tokens=4,
            frames=None if frames is None else frames(200 + i)))
    eng.step()                      # prefills all 8 and decodes once
    eng.step()                      # warm decode-only tick
    sync(device)

    def tick():
        eng.step()
        sync(device)

    out = profile_call(tick)
    eng.run()
    print(f"{label} decode profile: " + json.dumps(
        {k: v for k, v in out.items() if k != "top_kernels"}))
    return out


def deepseek_config():
    """deepseek-v3-671b as registered, with its one cut: 61 layers -> 4
    (three dense, one MoE: every block signature once)."""
    import dataclasses

    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("deepseek-v3-671b"), n_layers=4)


# ---------------------------------------------------------------------------
# deepseek-v3 retraining: the expert-batched backward (#3 and #4 over E
# experts), the MoE layer's gradients and the trainer at full width
# ---------------------------------------------------------------------------
RETRAIN_EXPERTS = 32          # routed experts of the retrain cut (of 256)
# rows per expert: the retrain's capacity (1024 tokens x top-8 / 32
# experts x 1.25 = 320: wgmma for bf16), a ragged 200 (not a multiple of
# the 64- or 128-row box: the 3-D maps must zero-fill per expert), and 40
# (simt for bf16 too)
EXPERT_GRAD_ROWS = (320, 200, 40)
# (E, C, K, N) cases whose rule cuts work, bf16 and f32: dx's clusters of
# 3 pieces at the down shape, dw's of 2 at a small tile grid, ragged
# rows, and the batched forward's clusters of 3 at the up/gate shape; at
# C = 64 the one row block takes one 64-row slice, inside the forward's
# (up/gate) and dx's (down) clusters of 3
EXPERT_GRAD_SPLIT_CASES = ((2, 100, 2048, 7168), (2, 2088, 1024, 1024),
                           (2, 100, 7168, 2048), (2, 64, 7168, 2048),
                           (2, 64, 2048, 7168))


def _tile_max(t, E, K, N):
    """(E, K / 128, N / 128) largest |value| of each 128x128 tile."""
    return t.view(E, K // 128, 128, N // 128, 128).abs().amax(dim=(2, 4))


def check_bsmm_batched_grads(B):
    """The expert-batched dx and dw against their plain versions at
    deepseek-v3's expert shapes (up/gate 7168 x 2048 with an all-dead
    K-row tile in the union, down 2048 x 7168), E = 32 sharing one ~25 %
    union plan, C = 320, 200 and 40 rows an expert, bf16 and f32, and at
    the split cases; each call held to the route and split count its
    rule gives, two calls bitwise equal, dw exactly zero on tiles dead in
    the union and nonzero on a tile live in the union but dead in expert
    0's own weights, dx zero under the dead K-row tile; the batched
    forward (#1b) at the same cases, held to its rule's route and split
    count, two calls bitwise equal, against its plain version; at C =
    320, bf16, a row's forward and dx bits unchanged when the other rows
    and experts change (rows of the first 128-row block and of the
    one-slice last block).  Times dx, dw and the batched forward at C =
    320, bf16.  Returns (errors, times)."""
    rng = np.random.default_rng(6)
    err = {"bsmm_batched_dx": 0.0, "bsmm_batched_dw": 0.0,
           "bsmm_batched": 0.0}
    times = []
    cases = [(RETRAIN_EXPERTS, EXPERT_GRAD_ROWS, K, N)
             for K, N in EXPERT_SHAPES]
    cases += [(E, (M,), K, N) for E, M, K, N in EXPERT_GRAD_SPLIT_CASES]
    for dtype in (torch.bfloat16, torch.float32):
        for E, rows, K, N in cases:
            bm = random_bitmap(rng, K, N)
            dead_k_row = (K, N) == EXPERT_SHAPES[0]
            if dead_k_row:
                bm[0] = False
                bm[1, 1] = True
            plan = B.make_tile_plan(np.kron(bm, np.ones((128, 128), bool)))
            dead = ~torch.as_tensor(bm, device="cuda")
            g_ = torch.Generator(device="cuda").manual_seed(K + 7 * N + E)
            w = (torch.randn(E, K, N, device="cuda", generator=g_)
                 / K ** 0.5).to(dtype)
            # the plan's first live tile, dead in expert 0's own mask
            k0, n0 = int(plan.kk[0]) * 128, int(plan.nn[0]) * 128
            w[0, k0:k0 + 128, n0:n0 + 128] = 0
            for M in rows:
                x = torch.randn(E, M, K, device="cuda", generator=g_).to(dtype)
                g = torch.randn(E, M, N, device="cuda", generator=g_).to(dtype)
                fwd_route, fwd_S = plan.route_and_splits("fwd", M, dtype, E)
                dx_route, dx_S = plan.route_and_splits("dx", M, dtype, E)
                dw_route, dw_S = plan.route_and_splits("dw", M, dtype, E)
                dx = held(B.bsmm_batched_dx, dx_route, dx_S, g, w, plan)
                dw = held(B.bsmm_batched_dw, dw_route, dw_S, x, g, plan)
                y = held(B.bsmm_batched, fwd_route, fwd_S, x, w, plan)
                require(torch.equal(y, B.bsmm_batched(x, w, plan)),
                        f"two bsmm_batched calls differ at E={E} M={M}")
                require(torch.equal(dx, B.bsmm_batched_dx(g, w, plan)),
                        f"two bsmm_batched_dx calls differ at E={E} M={M}")
                require(torch.equal(dw, B.bsmm_batched_dw(x, g, plan)),
                        f"two bsmm_batched_dw calls differ at E={E} M={M}")
                torch.cuda.synchronize()
                for name, got, want, route, S in (
                        ("bsmm_batched", y,
                         B.bsmm_batched_plain(x, w, plan), fwd_route, fwd_S),
                        ("bsmm_batched_dx", dx,
                         B.bsmm_batched_dx_plain(g, w, plan), dx_route, dx_S),
                        ("bsmm_batched_dw", dw,
                         B.bsmm_batched_dw_plain(x, g, plan), dw_route, dw_S)):
                    e = (got.float() - want.float()).abs().max().item()
                    tol = tolerance(dtype, want)
                    print(f"check {name} {str(dtype)[6:]} E={E} M={M} K={K} "
                          f"N={N} {route} splits={S} max_abs_err={e:.3e} "
                          f"tol={tol:.3e}")
                    require(torch.isfinite(got).all().item(),
                            f"{name} non-finite")
                    require(e <= tol, f"{name} disagrees with its plain "
                            f"version at E={E} M={M} K={K} N={N} {dtype}")
                    err[name] = max(err[name], e)
                    del want
                tiles = _tile_max(dw, E, K, N)
                require(tiles[:, dead].max().item() == 0,
                        f"bsmm_batched_dw wrote a tile dead in the union at "
                        f"K={K} N={N}")
                require(tiles[0, k0 // 128, n0 // 128].item() > 0,
                        "bsmm_batched_dw: no grad on a tile live in the union "
                        "but dead in expert 0")
                if dead_k_row:
                    require(not dx[..., :128].any().item(),
                            "bsmm_batched_dx is not zero under a K-row tile "
                            "dead in the union")
                if dtype == torch.bfloat16 and M == EXPERT_GRAD_ROWS[0]:
                    # expert 0's rows 0..M/2 and its last 32 rows (inside
                    # the last, one-slice 64-row block) against changed
                    # other rows and experts (the second 128-row block
                    # and the last one hold kept and changed rows)
                    h, t = M // 2, M - 32
                    x2, g2 = x.clone(), g.clone()
                    x2[1:], g2[1:] = -x2[1:], -g2[1:]
                    x2[0, h:t], g2[0, h:t] = 0, 0
                    y2 = B.bsmm_batched(x2, w, plan)[0]
                    dx2 = B.bsmm_batched_dx(g2, w, plan)[0]
                    require(all(torch.equal(a[r], b[0, r]) for a, b in
                                ((y2, y), (dx2, dx))
                                for r in (slice(0, h), slice(t, M))),
                            f"a row's batched forward or dx bits depend on "
                            f"other rows at K={K} N={N}")
                    del x2, g2
                    times.append(time_batched_grads(B, x, g, w, bm, plan, E,
                                                    M, K, N))
                del y, dx, dw, x, g
            del w
            torch.cuda.empty_cache()
    return err, times


def time_batched_grads(B, x, g, w, bm, plan, E, M, K, N):
    """The batched dx, dw and forward (#1b): kernel, plain and torch.bmm
    times (dx: g @ the masked dense experts transposed; dw: x^T @ g;
    forward: x @ the masked dense experts) with their bounds; a call
    reads more than the L2 holds."""
    row = {"E": E, "M": M, "K": K, "N": N, "dtype": "bfloat16",
           "live_tiles": plan.live_tiles, "total_tiles": plan.total_tiles}
    for kind in ("fwd", "dx", "dw"):
        row[f"{kind}_route"], row[f"{kind}_splits"] = plan.route_and_splits(
            kind, M, x.dtype, E)
    row["dx_ms"] = time_ms(lambda i: B.bsmm_batched_dx(g, w, plan), iters=10)
    row["dw_ms"] = time_ms(lambda i: B.bsmm_batched_dw(x, g, plan), iters=10)
    row["fwd_ms"] = time_ms(lambda i: B.bsmm_batched(x, w, plan), iters=10)
    row["dx_plain_ms"] = time_ms(
        lambda i: B.bsmm_batched_dx_plain(g, w, plan), iters=3, graph=False)
    row["dw_plain_ms"] = time_ms(
        lambda i: B.bsmm_batched_dw_plain(x, g, plan), iters=3, graph=False)
    row["fwd_plain_ms"] = time_ms(
        lambda i: B.bsmm_batched_plain(x, w, plan), iters=3, graph=False)
    dense = w * torch.as_tensor(np.kron(bm, np.ones((128, 128))),
                                dtype=w.dtype, device=w.device)
    row["dx_library_ms"] = time_ms(
        lambda i: torch.bmm(g, dense.transpose(1, 2)), iters=10)
    row["dw_library_ms"] = time_ms(
        lambda i: torch.bmm(x.transpose(1, 2), g), iters=10)
    row["fwd_library_ms"] = time_ms(lambda i: torch.bmm(x, dense), iters=10)
    del dense
    for kind in ("dx", "dw"):
        row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = grad_bound_ms(
            kind, M, K, N, plan, 2, "bfloat16", experts=E)
    row["fwd_bound_ms"], row["fwd_bound_by"] = bsmm_bound_ms(
        M, K, N, plan, 2, "bfloat16", experts=E)
    print("time bsmm_batched_grads " + json.dumps(row))
    return row


def deepseek_retrain_config():
    """deepseek-v3-671b at its published widths with two cuts: 61 layers
    -> 2 (one dense layer, one MoE layer: first_moe_layer 1) and 256
    routed experts -> 32 (4.10 G parameters, the most whose bf16 weights,
    grads and f32 AdamW moments fit the card's 80 GB)."""
    import dataclasses

    from repro_torch.configs import get_arch
    cfg = get_arch("deepseek-v3-671b")
    return dataclasses.replace(
        cfg, n_layers=2, moe=dataclasses.replace(
            cfg.moe, num_experts=RETRAIN_EXPERTS, first_moe_layer=1))


def moe_grad_check(cfg, device):
    """The MoE layer's ``moe_forward`` alone at full width (bf16, the
    retrain cut's experts) on one seeded input: the gradients of x, the
    router, the experts and the shared expert of ``Σ y ⊙ c + aux``
    through the ticket's plans (batched dx/dw for the experts, 2-D for
    the shared expert) against dense autograd on the masked weights,
    within 5e-2 of each gradient's scale.  The router's product is dense
    on both sides, so both route every token alike."""
    from repro_torch._bridge import tree_leaves, tree_map
    from repro_torch.core.masks import apply_masks_
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.plans import build_decode_plan

    gen = torch.Generator(device=device).manual_seed(5)
    params = moe_lib.moe_init(gen, cfg.d_model, cfg.moe, cfg.gated_mlp,
                              torch.bfloat16, torch.device(device))
    masks = build_expert_ticket({"segments": [[{"moe": params}]]},
                                device)["segments"][0][0]["moe"]
    apply_masks_(params, masks)
    plan = build_decode_plan({"segments": [[{"moe": masks}]]})[0][0][0]["moe"]
    x = torch.randn(8, 128, cfg.d_model, device=device, generator=gen,
                    dtype=torch.bfloat16)
    c = torch.randn(8, 128, cfg.d_model, device=device, generator=gen,
                    dtype=torch.bfloat16)

    def grads(plan):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        xx = x.detach().requires_grad_(True)
        mo = moe_lib.moe_forward(p, xx, cfg.moe, cfg.act, cfg.gated_mlp,
                                 plan=plan)
        loss = (mo.y.float() * c.float()).sum() + mo.aux_loss
        leaves = [xx] + tree_leaves(p)
        return mo, torch.autograd.grad(loss, leaves)

    mo_p, g_plan = grads(plan)
    mo_d, g_dense = grads(None)
    mask_of = {"up": masks["up"], "gate": masks["gate"],
               "down": masks["down"], "shared.up": masks["shared"]["up"],
               "shared.gate": masks["shared"]["gate"],
               "shared.down": masks["shared"]["down"]}
    order = ["x"] + [n for n, _ in _named_leaves(params)]
    worst = 0.0
    for name, gp, gd in zip(order, g_plan, g_dense):
        m = mask_of.get(name)
        gpm = gp.float() if m is None else gp.float() * m
        gdm = gd.float() if m is None else gd.float() * m
        e = (gpm - gdm).abs().max().item()
        scale = gdm.abs().max().item()
        worst = max(worst, e / max(scale, 1e-30))
        print(f"check moe grad {name} {tuple(gp.shape)} plan vs dense "
              f"max_abs_err={e:.4e} max|grad|={scale:.4e} "
              f"tol={5e-2 * scale:.4e}")
        require(bool(torch.isfinite(gp).all().item()), f"non-finite {name} "
                "grad")
        require(e <= 5e-2 * scale, f"the plan's {name} grad disagrees with "
                "the dense grad")
        del gpm, gdm
    drop = float(mo_p.drop_fraction)
    print(f"check moe grad: aux plan {mo_p.aux_loss.item():.6f} dense "
          f"{mo_d.aux_loss.item():.6f} drop_fraction {drop:.4f}")
    return {"grad_rel_err_max": worst, "aux_loss": mo_p.aux_loss.item(),
            "drop_fraction": drop}


def _named_leaves(tree, prefix=""):
    """(dotted path, leaf) in ``tree_leaves`` order (insertion order)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _ticket_mask_pairs(params, masks):
    """(parameter, bool mask) for every masked leaf of a deepseek ticket
    (``build_expert_ticket``)."""
    def walk(p, m):
        for k, v in m.items():
            if isinstance(v, dict):
                yield from walk(p[k], v)
            else:
                yield p[k], v
    for seg_p, seg_m in zip(params["segments"], masks["segments"]):
        for pos_p, pos_m in zip(seg_p, seg_m):
            yield from walk(pos_p, pos_m)


def retrain_deepseek(cfg, device, steps: int = 4):
    """``make_adapter(cfg).make_trainer(params, masks).run`` on deepseek-v3
    at full width (2 layers, 32 experts), a ticket of one seeded ~25 %
    bitmap per projection shared by the experts: finite losses and aux
    loss (> 0), finite parameters, pruned coordinates exactly zero,
    ``sent_fraction`` equal to the host count, and the launches a step
    must make of every bsmm kernel, each on the route its rows give;
    then one profiled step, which must show the batched forward, dx and
    dw."""
    from repro_torch._bridge import tree_leaves
    from repro_torch.api import make_adapter
    from repro_torch.kernels import bsmm as B
    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import expert_capacity
    from repro_torch.train import lm_train_plan

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    adapter = make_adapter(cfg, device=device, batch_size=8, seq_len=128)
    params = adapter.init_params(
        torch.Generator(device=device).manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    masks = build_expert_ticket(params, device)
    trainer = adapter.make_trainer(params, masks, learning_rate=1e-4)
    del params
    sync(device)
    setup_s = time.perf_counter() - t0
    # what the trainer holds between steps, before the first step and
    # after the last: the peak less these is the step's own transient
    held_setup = torch.cuda.memory_allocated() if on_card else None
    pairs = list(_ticket_mask_pairs(trainer.state.params, masks))
    prunable = sum(p.numel() for p, _ in pairs)
    pruned = sum(p.numel() - int(m.count_nonzero().item()) for p, m in pairs)
    want_sent = (n_params - pruned) / n_params
    # the planned peak, in GB (1e9 bytes): bf16 weights and grads, f32
    # AdamW moments, f32 masks on the prunable leaves, and the ~7 GB of
    # activations and temporaries llama's retrain leaves over its state
    reckoning = {"bf16_parameters": 2 * n_params / 1e9,
                 "bf16_grads": 2 * n_params / 1e9,
                 "f32_adamw_moments": 8 * n_params / 1e9,
                 "f32_masks_on_prunable": 4 * prunable / 1e9,
                 "activations_logits_temporaries": 7.0}
    reckoning["total"] = sum(reckoning.values())

    names = BSMM_ROUTED + BATCHED_ROUTED
    reset_bsmm_routes(B, names)
    losses, auxes, sent, step_s = [], [], [], []
    for _ in range(steps):
        ts = time.perf_counter()
        m = trainer.run(1)
        step_s.append(time.perf_counter() - ts)
        losses.append(m["loss"])
        auxes.append(m["aux"])
        sent.append(m["sent_fraction"])
    launches, routes = counts_now(B, names)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    held_steps = torch.cuda.memory_allocated() if on_card else None

    # per step: every MLP (the dense layer's and the MoE layer's shared
    # expert) runs up and down through bsmm and the gate through the
    # epilogue (once more in the backward's pre-activation), one dx and
    # one dw each; every MoE layer runs its three expert products
    # batched, forward, dx and dw; remat runs every forward twice
    n_moe = sum(1 for i in range(cfg.n_layers)
                if tfm.layer_signature(cfg, i)[1])
    mlps = cfg.n_layers - n_moe + n_moe * (cfg.moe.num_shared_experts > 0)
    r = 2 if tfm.remat_enabled() else 1
    want = {"bsmm": 2 * r * mlps, "bsmm_epilogue": (r + 1) * mlps,
            "bsmm_dx": 3 * mlps, "bsmm_dw": 3 * mlps,
            "bsmm_batched": 3 * r * n_moe, "bsmm_batched_dx": 3 * n_moe,
            "bsmm_batched_dw": 3 * n_moe}
    C = expert_capacity(8 * 128, cfg.moe)
    print(f"retrain_deepseek: remat={r == 2} layers={cfg.n_layers} "
          f"experts={cfg.moe.num_experts} capacity={C} losses={losses} "
          f"aux={auxes} sent_fraction={sent[-1]} (host {want_sent}) "
          f"launches={launches} per step want {want}")
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    require(all(np.isfinite(auxes)) and all(a > 0 for a in auxes),
            f"aux loss {auxes} is not finite and positive")
    require(all(abs(s_ - want_sent) < 1e-12 for s_ in sent),
            f"sent_fraction {sent} != host count {want_sent}")
    # every routed product on its wgmma kernel (2-D at 1024 rows, the
    # batched forward and backward at C rows an expert), cut where its
    # plan says
    plan, _ = lm_train_plan(masks)
    mlp_plans = [e.get("mlp") or e["moe"]["shared"] for seg in plan
                 for e in seg]
    expert_plans = [{k: e["moe"][k] for k in ("up", "gate", "down")}
                    for seg in plan for e in seg if "moe" in e]
    E = cfg.moe.num_experts

    def cut(p, kind, M, experts=1):
        return p.route_and_splits(kind, M, torch.bfloat16, experts)[1] > 1

    M = 8 * 128
    want_cut = {
        "bsmm": steps * r * sum(cut(p[k], "fwd", M) for p in mlp_plans
                                for k in ("up", "down")),
        "bsmm_epilogue": steps * (r + 1) * sum(cut(p["gate"], "fwd", M)
                                               for p in mlp_plans),
        "bsmm_dx": steps * sum(cut(q, "dx", M) for p in mlp_plans
                               for q in p.values()),
        "bsmm_dw": steps * sum(cut(q, "dw", M) for p in mlp_plans
                               for q in p.values()),
        "bsmm_batched": steps * r * sum(cut(q, "fwd", C, E)
                                        for p in expert_plans
                                        for q in p.values()),
        "bsmm_batched_dx": steps * sum(cut(q, "dx", C, E) for p in expert_plans
                                       for q in p.values()),
        "bsmm_batched_dw": steps * sum(cut(q, "dw", C, E) for p in expert_plans
                                       for q in p.values())}

    def require_steps(launches, routes, where):
        require(all(launches[k] == steps * v for k, v in want.items()),
                f"{where}: launch counts {launches} do not match {steps} "
                f"steps of {want}")
        for name, rt in routes.items():
            want_routes = {k: launches[name] * (k == "wgmma")
                           for k in rt["launches_by_route"]}
            require(rt["launches_by_route"] == want_routes
                    and rt["split_launches"] == want_cut[name],
                    f"{name} routes {rt} in {where}, want {want_routes} "
                    f"and {want_cut[name]} split launches")

    def require_ticket(params, where):
        require(all(bool(torch.isfinite(p).all().item())
                    for p in tree_leaves(params)),
                f"a parameter is non-finite after {where}")
        for p, m in _ticket_mask_pairs(params, masks):
            require(not bool(((p != 0) & ~m).any().item()),
                    f"a pruned coordinate is non-zero after {where}")

    require_steps(launches, routes, "the deepseek retrain")
    require_ticket(trainer.state.params, "retraining deepseek")

    tokens = 8 * 128
    mid = sorted(step_s[1:])
    step_med = mid[len(mid) // 2]
    profile = profile_step(trainer) if on_card else None
    if profile and profile["device_ms"] != "not measured":
        groups = profile["by_group_ms"]
        print("retrain_deepseek profile: " + json.dumps(
            {k: v for k, v in profile.items() if k != "top_kernels"}))
        for name in BATCHED_ROUTED:
            require(groups.get(name, 0.0) > 0, f"the profiled deepseek step "
                    f"shows no {name} kernel time")
    print(f"retrain_deepseek: peak {peak} bytes allocated (held after set-up "
          f"{held_setup}, after the steps {held_steps}); reckoning "
          + json.dumps(reckoning))

    # the QAT leg: the same cut, ticket and weights, a fresh optimizer
    # (the plain trainer and its moments freed first), the prunable
    # weights fake-quantized to int8 in the loss
    params = trainer.state.params
    del trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    qtrainer = adapter.make_trainer(params, masks, learning_rate=1e-4,
                                    quantize_bits=8)
    del params
    before = counts_now(B, names)
    q_losses, q_step_s, q_med, q_peak = timed_steps(qtrainer, steps, on_card)
    q_launches, q_routes = counts_since(B, before, names)
    print(f"retrain_deepseek QAT: losses {q_losses} steps {q_step_s} median "
          f"{q_med} s, peak {q_peak} bytes allocated (plain {peak})")
    require(all(np.isfinite(q_losses)), f"non-finite QAT loss {q_losses}")
    require_steps(q_launches, q_routes, "the deepseek QAT leg")
    require_ticket(qtrainer.state.params, "the deepseek QAT leg")
    del qtrainer
    qat = {"losses": q_losses, "step_s": q_step_s,
           "step_s_median_2_to_4": q_med, "tokens_per_s": 8 * 128 / q_med,
           "max_memory_allocated_bytes": q_peak, "launches": q_launches,
           "bsmm_routes": q_routes,
           "fake_copies_gb": 2 * prunable / 1e9}
    return launches, {
        "config": cfg.name, "n_layers": cfg.n_layers, "experts": E,
        "capacity": C, "parameters": n_params, "prunable": prunable,
        "setup_s": setup_s, "steps": steps, "remat": r == 2,
        "step_s": step_s, "step_s_median_2_to_4": step_med,
        "tokens_per_s": tokens / step_med, "losses": losses, "aux": auxes,
        "sent_fraction": sent[-1], "sent_fraction_host": want_sent,
        "max_memory_allocated_bytes": peak,
        "allocated_after_setup_bytes": held_setup,
        "allocated_after_steps_bytes": held_steps, "reckoning_gb": reckoning,
        "launches_per_step": want, "bsmm_routes": routes,
        "live_tiles": adapter.last_plan_stats.live_tiles,
        "total_tiles": adapter.last_plan_stats.total_tiles,
        "profile": profile, "qat": qat}


# ---------------------------------------------------------------------------
# the CNN slice: Algorithm 1 on vgg11 at full width, the device-side
# crossbar accounting of its ticket (kernel #9), an FC-tiling variant's
# block-sparse retrain and the LTP baseline's product (kernel #5)
# ---------------------------------------------------------------------------
CNN_ROUNDS = 4          # prune rounds (max_iters; the paper runs to 20)
CNN_STEPS = 100         # train steps per round (cnn-full: 300-400)
CNN_RATE = 0.05         # per prune round (cnn-full: 0.25, 0.25, 0.20)
CNN_TOLERANCE = 0.02    # accuracy gate, as examples/prune_cnn_lottery.py
CNN_BATCH = 128
LTP_SHAPE = (3072, 8192)
LTP_ROWS = (8, 1024)
STATS_CASES = ((4608, 512, torch.float32, 128, 128),     # vgg11's convs 6-7
               (3072, 8192, torch.bfloat16, 128, 128),
               (1000, 333, torch.float32, 64, 256))      # ragged, non-square


def rel_err(got, want) -> float:
    """Largest |got - want| relative to |want| (0 where both are 0)."""
    d = (got.float() - want.float()).abs()
    return (d / want.float().abs().clamp_min(1e-30)).max().item()


def check_tile_stats(TS):
    """Kernel #9 against its plain version (liveness exact, sums within
    1e-5 relative) at vgg11's 4608 x 512 conv matrix (f32), a 3072 x 8192
    bf16 weight and a ragged 64 x 256 geometry; timed at the first two.
    Returns (max relative sums error, times)."""
    err, times = 0.0, []
    for K, N, dtype, bk, bn in STATS_CASES:
        g = torch.Generator(device="cuda").manual_seed(K + N)
        w = torch.randn(K, N, device="cuda", generator=g).to(dtype)
        w[:2 * bk, :bn] = 0            # dead tiles
        live, sums = TS.tile_stats(w, bk=bk, bn=bn)
        p_live, p_sums = TS.tile_stats_plain(w, bk, bn)
        torch.cuda.synchronize()
        e = rel_err(sums, p_sums)
        print(f"check tile_stats {str(dtype)[6:]} K={K} N={N} tile={bk}x{bn} "
              f"live_equal={bool((live == p_live).all().item())} "
              f"sums_rel_err={e:.3e} tol=1e-05")
        require(bool((live == p_live).all().item()),
                "tile_stats liveness disagrees with its plain version")
        require(e <= 1e-5, "tile_stats sums disagree with their plain version")
        require(int(live[0, 0].item()) == 0, "a dead tile reads as live")
        err = max(err, e)
        if (bk, bn) == (128, 128):
            elem = w.element_size()
            nbytes = K * N * elem + live.numel() * 8
            row = {"K": K, "N": N, "dtype": str(dtype)[6:],
                   "ms": time_ms(lambda i: TS.tile_stats(w, bk=bk, bn=bn)),
                   "plain_ms": time_ms(lambda i: TS.tile_stats_plain(w, bk, bn),
                                       iters=5, graph=False),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "bound_by": "bytes", "library_ms": None}
            print("time tile_stats " + json.dumps(row))
            times.append(row)
    return err, times


def masked_call(B, x, w, m):
    """One call of kernel #5, held to the kernel ``masked_route`` names
    (every M < 64 on ``stream``, every bfloat16 M >= 64 on ``wgmma``,
    float32 from 64 rows on ``fma``) by the per-kernel counts, and to
    ``masked_splits`` by the split count; returns (output, kernel)."""
    M, K = x.shape
    N = w.shape[1]
    want = B.masked_route(M, K, N, x.dtype)
    require(want == ("stream" if M < 64 else
                     "wgmma" if x.dtype == torch.bfloat16 else "fma"),
            f"masked_route gives {want} at M={M} {x.dtype}")
    split = want != "wgmma" and len(B.masked_splits(M, K, N)) > 1
    before = dict(B.masked_matmul.launches_by_route)
    s0 = B.masked_matmul.split_launches
    out = B.masked_matmul(x, w, m, bm=1)
    after = B.masked_matmul.launches_by_route
    require({k: after[k] - before[k] for k in after}
            == {k: int(k == want) for k in after}
            and B.masked_matmul.split_launches - s0 == int(split),
            f"masked_matmul at M={M} {x.dtype} did not run the {want} "
            f"kernel{' split over K' if split else ''}")
    return out, want


def check_masked_nan(B, x, w, m_tile, m_iid):
    """NaN in w under a dead tile (column tile 0 of the tile mask) leaves
    the output finite; NaN under a zero mask element of a live tile
    gives NaN exactly where the plain version has it."""
    w2 = w.clone()
    w2[:128, :128] = float("nan")
    require(torch.isfinite(masked_call(B, x, w2, m_tile)[0]).all().item(),
            "masked_matmul let NaN under a dead tile through")
    k, n = ((m_iid[:128, :128] == 0).nonzero()[0]).tolist()
    w2 = w.clone()
    w2[k, n] = float("nan")
    got = torch.isnan(masked_call(B, x, w2, m_iid)[0])
    want = torch.isnan(B.masked_matmul_plain(x, w2, m_iid))
    print(f"check masked_matmul NaN rules {str(x.dtype)[6:]} M={x.shape[0]}: "
          f"dead tile finite, live tile NaN in {int(got.any(0).sum())} "
          f"column(s) as the plain version")
    require(bool(got[:, n].all()) and torch.equal(got, want),
            "masked_matmul's NaN under a live tile differs from its plain "
            "version")


def masked_row(B, x, w, m, mb, kind, route):
    """Kernel, plain, kernel #1 (on the same tile plan) and torch.matmul
    (on the dense masked weight) times, and the bound: every byte of w
    and mask, x and out, or the live tiles' flops."""
    M, K = x.shape
    N = w.shape[1]
    plan = B.make_tile_plan(mb.cpu().numpy())
    wm = w * m
    elem = w.element_size()
    nbytes = K * N * (elem + m.element_size()) + M * K * elem + M * N * elem
    flops = 2.0 * M * plan.live_tiles * 128 * 128
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / PEAK_FLOPS[str(x.dtype)[6:]] * 1e3
    row = {"M": M, "K": K, "N": N, "dtype": str(x.dtype)[6:],
           "mask": kind, "mask_dtype": str(m.dtype)[6:], "route": route,
           "splits": 1 if route == "wgmma" else len(B.masked_splits(M, K, N)),
           "live_tiles": plan.live_tiles, "total_tiles": plan.total_tiles,
           "ms": time_ms(lambda i: B.masked_matmul(x, w, m, bm=1)),
           "plain_ms": time_ms(lambda i: B.masked_matmul_plain(x, w, m),
                               iters=5, graph=False),
           "bsmm_ms": time_ms(lambda i: B.bsmm(x, wm, plan)),
           "library_ms": time_ms(lambda i: torch.matmul(x, wm)),
           "bound_ms": max(t_b, t_o),
           "bound_by": "bytes" if t_b >= t_o else "operations"}
    print("time masked_matmul " + json.dumps(row))
    return row


MASKED_CHECK_ROWS = (1, 12, 40, 100, 128, 300)   # every route, ragged rows
FC_SHAPE = (CNN_BATCH, 512, 512)          # vgg11-fc512's FC weight


def check_masked(B):
    """Kernel #5 against its plain version on 3072 x 8192, f32 and bf16,
    M = 8 and 1024, with (a) an iid ~90 %-sparse LTP mask (nearly every
    tile live) and (b) a ~25 %-live tile bitmap expanded; every call
    held to its route, a second call held bitwise to the first, the NaN
    rules at both row counts; timed beside kernel #1 on the same tile
    plan (the crossbar-aware product, which skips the dead tiles' bytes
    too) and torch.matmul on the dense masked weight.  The mask is in
    w's dtype, as the reference's.  Then bf16 at M = 1, 12, 40, 100, 128
    and 300 (untimed), and the CNN path's own call, the 512 x 512 f32 FC
    weight at M = 128 under a 50 % iid mask, timed.  Returns (max error,
    times, the wgmma route's shared memory by mask dtype)."""
    rng = np.random.default_rng(9)
    K, N = LTP_SHAPE
    err, times = 0.0, []
    smem = {str(d)[6:]: B.masked_wgmma_smem_bytes(d)
            for d in (torch.bool, torch.bfloat16, torch.float32)}
    print(f"masked_matmul wgmma route: shared memory by mask dtype {smem} "
          f"bytes (a block may take 232448)")

    def checked(x, w, m, what):
        got, route = masked_call(B, x, w, m)
        want = B.masked_matmul_plain(x, w, m)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        tol = tolerance(x.dtype, want)
        same = torch.equal(got, masked_call(B, x, w, m)[0])
        print(f"check masked_matmul {str(x.dtype)[6:]} {what} M={x.shape[0]} "
              f"K={w.shape[0]} N={w.shape[1]} route={route} "
              f"max_abs_err={e:.3e} tol={tol:.3e} repeat_bitwise={same}")
        require(torch.isfinite(got).all().item(), "masked_matmul non-finite")
        require(e <= tol, f"masked_matmul disagrees with its plain version "
                f"at M={x.shape[0]} {what} {x.dtype}")
        require(same, "two masked_matmul calls gave different bits")
        return e, route

    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device="cuda").manual_seed(77)
        w = (torch.randn(K, N, device="cuda", generator=g) / K ** 0.5
             ).to(dtype)
        tile = np.kron(random_bitmap(rng, K, N), np.ones((128, 128), bool))
        masks = {"ltp_iid_10pct": torch.rand(K, N, device="cuda",
                                             generator=g) < 0.1,
                 "tile_25pct": torch.as_tensor(tile, device="cuda")}
        for M in LTP_ROWS:
            x = torch.randn(M, K, device="cuda", generator=g).to(dtype)
            for kind, mb in masks.items():
                m = mb.to(dtype)
                e, route = checked(x, w, m, kind)
                err = max(err, e)
                times.append(masked_row(B, x, w, m, mb, kind, route))
            check_masked_nan(B, x, w, masks["tile_25pct"].to(dtype),
                             masks["ltp_iid_10pct"].to(dtype))
        if dtype == torch.bfloat16:
            m = masks["ltp_iid_10pct"].to(dtype)
            for M in MASKED_CHECK_ROWS:
                x = torch.randn(M, K, device="cuda", generator=g).to(dtype)
                err = max(err, checked(x, w, m, "ltp_iid_10pct")[0])
        del w, masks
    M, K, N = FC_SHAPE
    g = torch.Generator(device="cuda").manual_seed(512)
    w = torch.randn(K, N, device="cuda", generator=g) / K ** 0.5
    mb = torch.rand(K, N, device="cuda", generator=g) < 0.5
    x = torch.relu(torch.randn(M, K, device="cuda", generator=g))
    e, route = checked(x, w, mb.float(), "fc_ltp_50pct")
    require(route == "fma" and len(B.masked_splits(M, K, N)) > 1,
            "the CNN path's FC call did not take the split CUDA-core kernel")
    err = max(err, e)
    times.append(masked_row(B, x, w, mb.float(), mb, "fc_ltp_50pct", route))
    return err, times, smem


LTP_MLP_ROWS = (8, 1024)    # decode (the serve phase's 8 slots), prefill
LTP_MLP_KEEP = 0.1          # the ltp prune keeps the largest 10 % of |w|


def ltp_mlp(cfg, device):
    """The crossbar-unaware LTP baseline where kernel #5's ``stream`` and
    ``wgmma`` kernels run: one layer of llama3.2-3b's gated MLP at full
    width (``mlp_init``: up and gate d_model x d_ff, down d_ff x d_model,
    bf16, seeded), pruned by the ``ltp`` criterion (each weight its own
    group scored by |w|, as ``core.strategies.LTPStrategy`` scores it,
    the lowest 90 % across the three weights killed at once, as
    ``select_global_prune`` picks; computed on the card, since the host
    prune step loops per weight), run as ``down(act(x @ gate) * (x @
    up))`` with every product through #5, at decode rows (8) and prefill
    rows (1024).  #5's counts are set to 0 just before and read just
    after: three launches a row count, the decode ones on ``stream``
    (split over K), the prefill ones on ``wgmma``.  The output is held
    to the same MLP through ``masked_matmul_plain``, and the MLP is
    timed beside ``torch.matmul`` on the masked weights."""
    from repro_torch.kernels import bsmm as B
    from repro_torch.models.layers import _act, mlp_init

    g = torch.Generator(device=device).manual_seed(21)
    p = mlp_init(g, cfg.d_model, cfg.d_ff, gated=True, bias=False,
                 dtype=torch.bfloat16, device=device)
    keys = ("up", "gate", "down")
    mags = torch.cat([p[k].abs().float().flatten() for k in keys])
    thr = torch.sort(mags).values[int((1 - LTP_MLP_KEEP) * mags.numel())]
    del mags
    masks = {k: (p[k].abs().float() > thr).to(torch.bfloat16) for k in keys}
    wm = {k: p[k] * masks[k] for k in keys}
    xs = {M: torch.randn(M, cfg.d_model, device=device, generator=g)
          .to(torch.bfloat16) for M in LTP_MLP_ROWS}

    def forward(mm, x):
        up = mm(x, "up")
        return mm(_act(cfg.act, mm(x, "gate")) * up, "down")

    def kernel(x, k):
        return B.masked_matmul(x, p[k], masks[k], bm=1)

    def plain(x, k):
        return B.masked_matmul_plain(x, p[k], masks[k])

    def library(x, k):
        return torch.matmul(x, wm[k])

    B.masked_matmul.launches = 0
    B.masked_matmul.launches_by_route.update(stream=0, wgmma=0, fma=0)
    B.masked_matmul.split_launches = 0
    outs = {M: forward(kernel, x) for M, x in xs.items()}
    sync(device)
    by_route = dict(B.masked_matmul.launches_by_route)
    summary = {"launches": B.masked_matmul.launches,
               "launches_by_route": by_route,
               "split_launches": B.masked_matmul.split_launches}
    print(f"ltp mlp: masked_matmul launches {summary}")
    require(by_route == {"stream": 3, "wgmma": 3, "fma": 0}
            and summary["launches"] == 6 and summary["split_launches"] == 3,
            "the LTP MLP's decode products did not stream split-K or its "
            "prefill products did not run the wgmma kernel")
    live, tiles = {}, 0
    for k in keys:
        K, N = masks[k].shape
        t = (masks[k] != 0).reshape(K // 128, 128, N // 128, 128) \
            .any(3).any(1)
        live[k] = float((masks[k] != 0).float().mean().item())
        tiles += int(t.sum().item()) * 128 * 128
    nbytes = sum(p[k].numel() * 4 for k in keys)         # bf16 w and mask
    rows, err = [], 0.0
    for M, x in xs.items():
        want = forward(plain, x)
        got = outs[M]
        e = (got.float() - want.float()).abs().max().item()
        tol = tolerance(torch.bfloat16, want)
        print(f"check ltp mlp M={M}: max_abs_err={e:.3e} tol={tol:.3e}")
        require(bool(torch.isfinite(got).all().item()),
                "the LTP MLP gave non-finite output")
        require(e <= tol, f"the LTP MLP disagrees with its plain version at "
                f"M={M}")
        err = max(err, e)
        t_b = (nbytes + 2 * M * (2 * cfg.d_model + 3 * cfg.d_ff)) \
            / HBM_BYTES_PER_S * 1e3
        t_o = 2.0 * M * tiles / PEAK_FLOPS["bfloat16"] * 1e3
        row = {"M": M, "ms": time_ms(lambda i: forward(kernel, x)),
               "plain_ms": time_ms(lambda i: forward(plain, x), iters=5,
                                   graph=False),
               "library_ms": time_ms(lambda i: forward(library, x)),
               "bound_ms": max(t_b, t_o),
               "bound_by": "bytes" if t_b >= t_o else "operations"}
        print("time ltp_mlp " + json.dumps(row))
        rows.append(row)
    summary.update(max_abs_err=err, live_fraction=live,
                   live_tile_fraction=tiles / sum(p[k].numel() for k in keys),
                   times=rows)
    return summary


def _timed(adapter, device, train_s, losses, accs):
    """Wrap the adapter's train and evaluate to record each train's
    wall time (synchronised) and loss, and every accuracy."""
    train, evaluate = adapter.train, adapter.evaluate

    def timed_train(*a, **kw):
        ts = time.perf_counter()
        out = train(*a, **kw)
        sync(device)
        train_s.append(time.perf_counter() - ts)
        losses.append(float(adapter.last_metrics["loss"]))
        return out

    def recorded_evaluate(*a, **kw):
        accs.append(evaluate(*a, **kw))
        return accs[-1]

    adapter.train, adapter.evaluate = timed_train, recorded_evaluate


def cnn_session(device, rounds=CNN_ROUNDS, steps=CNN_STEPS):
    """Algorithm 1 on vgg11 at its published widths, through the entry
    points a user calls: ``make_adapter(scale="full")`` and
    ``PruningSession(...).run()`` with the family's tuned recipe cut to
    ``steps`` per round, ``rounds`` prune rounds and a prune rate of
    ``CNN_RATE`` a round; then the hardware report, the ticket's export
    and re-import, and a finetune.  Data is ``SyntheticImages`` (the
    datasets are not in the repository).  The rate is cut because the
    gate scores each prune before any retraining: after 100 steps on
    this data a 25 % structured prune drops vgg11's accuracy to
    0.2-0.8, and no round would pass."""
    import dataclasses
    import shutil

    from repro_torch._bridge import tree_leaves
    from repro_torch.api import PruningSession, get_recipe, make_adapter
    from repro_torch.configs import PruneConfig
    from repro_torch.core import lottery

    adapter = make_adapter("vgg11", scale="full", steps=steps,
                           batch_size=CNN_BATCH, lr=0.1, lr_decay=0.95,
                           device=device)
    require(adapter.use_bsmm == (torch.device(device).type == "cuda"),
            "CNNAdapter's use_bsmm does not follow its device")
    train_s, losses, accs, events = [], [], [], []
    _timed(adapter, device, train_s, losses, accs)
    family = get_recipe(adapter.recipe).with_retrain_steps(steps)
    recipe = family.replace(stages=tuple(
        dataclasses.replace(s, rate=CNN_RATE) if s.kind == "prune" else s
        for s in family.stages))
    t0 = time.perf_counter()
    event_t = []

    def on_event(e):
        sync(device)
        events.append(e)
        event_t.append(time.perf_counter())

    sess = PruningSession(adapter, PruneConfig(
        max_iters=rounds, accuracy_tolerance=CNN_TOLERANCE),
        recipe=recipe, callbacks=[on_event])
    res = sess.run()
    sync(device)
    run_s = time.perf_counter() - t0
    # each round's wall time (the first also holds the baseline's train)
    round_s = [b - a for a, b in zip([t0] + event_t, event_t)]
    for e in events:
        print(f"cnn event {e.iteration} [{e.stage}] {e.kind} "
              f"{e.granularity}: {'accepted' if e.accepted else 'undone'} "
              f"sparsity {e.sparsity_before:.4f} -> {e.sparsity_after:.4f} "
              f"accuracy {e.accuracy:.4f}")
    rep = sess.hardware_report()
    reram = reram_model(sess)
    ticket = OUT / "cnn_ticket"
    sess.export_ticket(str(ticket))
    w_back, m_back = lottery.import_ticket(str(ticket), sess.init_params,
                                           res.masks)
    meta = lottery.ticket_meta(str(ticket))
    shutil.rmtree(ticket)
    same = all(bool(torch.equal(a, b)) for a, b in zip(
        tree_leaves(w_back) + tree_leaves(m_back),
        tree_leaves(sess.init_params) + tree_leaves(res.masks)))
    tuned = sess.finetune(steps=steps)
    final_acc = adapter.evaluate(tuned, res.masks)
    train_s = list(train_s)             # the profiled train is not counted
    profile = (profile_call(lambda: adapter.train(res.params, res.masks, 3))
               if torch.device(device).type == "cuda" else None)
    require(all(np.isfinite(losses)), f"non-finite CNN loss {losses}")
    require(any(e.accepted and e.kind == "prune" for e in events),
            "no prune round was accepted")
    require(same, "the re-imported ticket differs from the exported one")
    require(meta.get("arch") == "vgg11", f"ticket meta {meta}")
    require(all(bool(torch.isfinite(t).all().item())
                for t in tree_leaves(tuned)), "non-finite finetuned weight")
    n_steps = steps * len(train_s)
    summary = {
        "config": "vgg11", "params": adapter.cfg.param_count(),
        "rounds": rounds, "steps_per_round": steps, "batch": CNN_BATCH,
        "rate": CNN_RATE, "accuracy_tolerance": CNN_TOLERANCE,
        "recipe": recipe.name, "cudnn_allow_tf32":
            torch.backends.cudnn.allow_tf32,
        "events": [{"stage": e.stage, "kind": e.kind,
                    "granularity": e.granularity, "accepted": e.accepted,
                    "sparsity": e.sparsity_after, "accuracy": e.accuracy}
                   for e in events],
        "baseline_accuracy": accs[0], "final_accuracy": final_acc,
        "sparsity": res.sparsity, "losses": losses,
        "train_s": train_s, "round_s": round_s, "session_s": run_s,
        "train_steps_per_s": n_steps / sum(train_s),
        "profile_3_steps": profile,
        "quantize_bits": sess.quantize_bits, "reram_model": reram,
        "hardware": {"xbar_savings": rep.xbar_savings,
                     "cell_savings": rep.cell_savings,
                     "xbars_unpruned": rep.xbars_unpruned,
                     "xbars_needed": rep.xbars_needed,
                     "xbars_needed_strict": rep.xbars_needed_strict,
                     "activation_savings": rep.activation_savings}}
    print("cnn session: " + json.dumps({k: v for k, v in summary.items()
                                        if k != "losses"}))
    return sess, res, summary


def reram_model(sess) -> dict:
    """The paper's pipelined ReRAM chip (``core.perf_model``) fed the
    ticket's crossbar counts at the session's geometry and vgg11's
    activation volumes: the training speedup at equal area (Fig. 7) and
    the crossbars needed at equal performance (Fig. 6).  Numbers of the
    modelled chip, not times of this device."""
    from repro_torch.core import perf_model as pm
    from repro_torch.core.hardware import cnn_activation_volumes

    cfg = sess.adapter.cfg
    vols = cnn_activation_volumes(cfg)
    rep = sess.hardware_report(activation_volumes=vols)
    cells = sess.geometry.cells
    unpruned = pm.conv_layer_perf(
        cfg, {lr.path: lr.stats.n_xbars for lr in rep.layers}, vols,
        act_cells_per_xbar=cells)
    pruned = pm.conv_layer_perf(
        cfg, {lr.path: lr.stats.xbars_needed_packed for lr in rep.layers},
        vols, act_cells_per_xbar=cells)
    speedup = pm.iso_area_speedup(unpruned, pruned)
    xbars = pm.iso_perf_xbars(unpruned, pruned)
    print(f"ReRAM model (the paper's chip, {pm.TOTAL_XBARS} crossbars at "
          f"{pm.XBAR_FREQ_HZ / 1e6:.0f} MHz): iso-area training speedup "
          f"{speedup:.4f}x, iso-performance crossbars {json.dumps(xbars)}")
    require(np.isfinite(speedup) and speedup >= 1.0,
            f"the ReRAM model's iso-area speedup {speedup} is below 1")
    require(0.0 <= xbars["savings"] < 1.0, f"iso-performance {xbars}")
    return {"iso_area_speedup": speedup, "iso_perf_xbars": xbars,
            "cycles_per_image_unpruned": pm.waterfill(unpruned)
            .cycles_per_image,
            "cycles_per_image_pruned": pm.waterfill(pruned).cycles_per_image}


def cnn_ticket_stats(sess, res):
    """Kernel #9 on every pruned leaf of the session's ticket (w_init ⊙
    mask on the card, convs unrolled im2col to (IC·K·K, OC) with rows
    (ic, kx, ky)) through ``tile_stats_for_config`` at the session's
    geometry and at 64 x 256: liveness equal to the plain version and
    its count equal to the host ``xbar_stats(...).xbars_needed_strict``
    of that leaf's mask, sums within 1e-5 relative."""
    from repro_torch._bridge import to_numpy
    from repro_torch.configs import PruneConfig
    from repro_torch.core import crossbar as xb
    from repro_torch.core.masks import tree_flatten_with_path
    from repro_torch.kernels import tile_stats as TS

    params = dict(tree_flatten_with_path(res.params))
    leaves = [(p, m) for p, m in tree_flatten_with_path(res.masks)
              if m is not None]
    out = {}
    for cfg in (sess.cfg, PruneConfig(xbar_rows=64, xbar_cols=256)):
        xr, xc = cfg.xbar_rows, cfg.xbar_cols
        live_total = strict_total = 0
        err = 0.0
        for path, m in leaves:
            w = params[path]
            conv = sess.adapter.conv_pred(path)
            mat = (w.permute(2, 0, 1, 3).reshape(-1, w.shape[3]) if conv
                   else w).contiguous()
            live, sums = TS.tile_stats_for_config(mat, cfg)
            p_live, p_sums = TS.tile_stats_plain(mat, xr, xc)
            host = xb.xbar_stats(xb.leaf_matrices(to_numpy(m), conv)[0][0]
                                 != 0, xr, xc).xbars_needed_strict
            n_live = int(live.sum().item())
            require(bool((live == p_live).all().item()),
                    f"tile_stats liveness of {path} disagrees with plain")
            require(n_live == host, f"{path}: {n_live} live tiles on the "
                    f"card, {host} crossbars on the host at {xr}x{xc}")
            e = rel_err(sums, p_sums)
            require(e <= 1e-5, f"tile_stats sums of {path} off by {e:.3e}")
            err = max(err, e)
            live_total += n_live
            strict_total += host
        out[f"{xr}x{xc}"] = {"leaves": len(leaves), "live_tiles": live_total,
                             "xbars_needed_strict_host": strict_total,
                             "sums_rel_err": err}
    print("cnn ticket tile_stats: " + json.dumps(out))
    return out


def cnn_fc_variant(device, steps=CNN_STEPS):
    """A test variant, not a published config: vgg11's convs with one
    512-wide FC layer (``fc=(512,)``), whose 512 x 512 weight tiles at
    128.  Retrained one round under a ~25 %-live tile mask, its FC layer
    runs kernel #2 forward (and again to recompute the pre-activation
    in the backward), #3 and #4 backward, every step.  Then the LTP
    baseline's product of its FC layer (kernel #5) under an unstructured
    ``ltp`` prune of the retrained ticket, at the retrain's row count."""
    import dataclasses

    from repro_torch.api import CNNAdapter
    from repro_torch.configs import get_cnn
    from repro_torch.core.algorithm import prune_step
    from repro_torch.core.masks import make_masks
    from repro_torch.kernels import bsmm as B

    cfg = dataclasses.replace(get_cnn("vgg11"), fc=(512,),
                              name="vgg11-fc512-test")
    adapter = CNNAdapter(cfg, steps=steps, batch_size=CNN_BATCH, lr=0.1,
                         device=device)
    params = adapter.init_params(torch.Generator(device=device).manual_seed(1))
    masks = make_masks(params, adapter.prunable)
    bm = np.random.default_rng(4).random((4, 4)) < 0.25
    bm[0, 0] = True
    masks["fc"][0]["w"] = torch.as_tensor(
        np.kron(bm, np.ones((128, 128))), dtype=torch.float32, device=device)
    counters = (B.bsmm, B.bsmm_epilogue, B.bsmm_dx, B.bsmm_dw)
    before = {f.__name__: f.launches for f in counters}
    routes0 = bsmm_routes(B)
    tuned = adapter.train(params, masks)
    sync(device)
    per_step = {f.__name__: (f.launches - before[f.__name__]) / steps
                for f in counters}
    routes = {name: {k: v - routes0[name]["launches_by_route"][k]
                     for k, v in r["launches_by_route"].items()}
              for name, r in bsmm_routes(B).items()}
    splits = {name: r["split_launches"] - routes0[name]["split_launches"]
              for name, r in bsmm_routes(B).items()}
    # the FC layer's 512 x 512 product at the batch's 128 rows in f32:
    # the CUDA-core kernels, uncut (4 K tiles a column at most)
    fc_plan = B.make_tile_plan(masks["fc"][0]["w"].cpu().numpy())
    cut = [fc_plan.route_and_splits(k, CNN_BATCH, torch.float32)
           for k in ("fwd", "dx", "dw")]
    print(f"cnn fc variant routes {routes}, split launches {splits}, "
          f"plan routes {cut}")
    require(cut == [("fma", 1), ("simt", 1), ("fma", 1)]
            and routes == {"bsmm": {"stream": 0, "wgmma": 0, "fma": 0},
                           "bsmm_epilogue": {"stream": 0, "wgmma": 0,
                                             "fma": 2 * steps},
                           "bsmm_dx": {"simt": steps, "wgmma": 0},
                           "bsmm_dw": {"wgmma": 0, "fma": steps}}
            and not any(splits.values()),
            "the FC variant's bsmm did not run its CUDA-core routes uncut")
    want = {"bsmm": 0, "bsmm_epilogue": 2, "bsmm_dx": 1, "bsmm_dw": 1}
    loss = float(adapter.last_metrics["loss"])
    print(f"cnn fc variant: {adapter.last_plan_stats.routed} routed, "
          f"{adapter.last_plan_stats.live_tiles}/"
          f"{adapter.last_plan_stats.total_tiles} tiles live, loss {loss}, "
          f"launches per step {per_step}, want {want}")
    require(np.isfinite(loss), "non-finite FC-variant loss")
    require(per_step == want, "FC-variant bsmm launches per step")
    require(not bool(((tuned["fc"][0]["w"] != 0)
                      & (masks["fc"][0]["w"] == 0)).any().item()),
            "a pruned FC coordinate is non-zero after retraining")

    ltp = prune_step(tuned, masks, "ltp", 0.5, adapter.conv_pred)
    w, m = tuned["fc"][0]["w"], ltp["fc"][0]["w"]
    g = torch.Generator(device=device).manual_seed(5)
    x = torch.relu(torch.randn(CNN_BATCH, w.shape[0], device=device,
                               generator=g))
    got = B.masked_matmul(x, w, m)
    want_out = B.masked_matmul_plain(x, w, m)
    sync(device)
    e = (got - want_out).abs().max().item()
    tol = tolerance(torch.float32, want_out)
    live = float((m != 0).float().mean().item())
    print(f"cnn ltp product: fc mask {live:.4f} live, "
          f"max_abs_err={e:.3e} tol={tol:.3e}")
    require(e <= tol, "the LTP product disagrees with its plain version")
    return {"config": cfg.name, "steps": steps, "loss": loss,
            "launches_per_step": per_step, "bsmm_routes": routes,
            "live_tiles": adapter.last_plan_stats.live_tiles,
            "total_tiles": adapter.last_plan_stats.total_tiles,
            "ltp_fc_live_fraction": live, "ltp_max_abs_err": e}


def cnn_phase(device):
    """The CNN path, with every kernel's count set to 0 just before and
    read just after: the vgg11 session, its ticket's crossbar accounting
    on the card (#9), the FC-tiling variant (#2, #3, #4) and the LTP
    product (#5)."""
    from repro_torch.kernels import bsmm as B
    from repro_torch.kernels import tile_stats as TS

    counters = (B.bsmm, B.bsmm_epilogue, B.bsmm_dx, B.bsmm_dw,
                B.masked_matmul, TS.tile_stats)
    for f in counters:
        f.launches = 0
    by_route = B.masked_matmul.launches_by_route
    for k in by_route:
        by_route[k] = 0
    B.masked_matmul.split_launches = 0
    sess, res, summary = cnn_session(device)
    summary["ticket_tile_stats"] = cnn_ticket_stats(sess, res)
    summary["fc_variant"] = cnn_fc_variant(device)
    launches = {f.__name__: f.launches for f in counters}
    n = launches["masked_matmul"]
    summary["masked_matmul_launches_by_route"] = dict(by_route)
    summary["masked_matmul_split_launches"] = B.masked_matmul.split_launches
    print(f"cnn launches {launches}, masked_matmul by kernel "
          f"{dict(by_route)}, split {B.masked_matmul.split_launches}")
    require(by_route == {"stream": 0, "wgmma": 0, "fma": n}
            and B.masked_matmul.split_launches == n,
            "the CNN path's LTP product did not take the split CUDA-core "
            "kernel")
    for name in ("bsmm_epilogue", "bsmm_dx", "bsmm_dw", "masked_matmul",
                 "tile_stats"):
        require(launches[name] > 0, f"the CNN path never launched {name}")
    summary["launches"] = launches
    return launches, summary


def resnet_step_check(batch=16):
    """One full-width resnet18 train step (loss, gradients, new BN state)
    on the card against the same step on the CPU, from one seeded
    initialisation, in float32 with TF32 off for the check (cuDNN and
    matmul): the stride-2 SAME padding and the shortcut BatchNorm on the
    card.  At initialisation the last stage's gradients come out of
    BatchNorm's backward as small differences of large terms, so float32
    rounding alone moves them by up to ~20 % (the CPU in float32 against
    the CPU in float64).  So both float32 runs are held against a
    float64 CPU run: every leaf of the card's loss, gradients and state
    must be within 2x the CPU float32 run's error of it, plus 1e-5 of
    the leaf's scale."""
    from repro_torch._bridge import tree_leaves, tree_map, tree_unflatten
    from repro_torch.configs import get_cnn
    from repro_torch.core.masks import tree_flatten_with_path
    from repro_torch.data import SyntheticImages
    from repro_torch.models import cnn

    cfg = get_cnn("resnet18")
    params, state = cnn.init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    b = SyntheticImages().batch(0, batch)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for key, dev, dtype in (("cpu64", "cpu", torch.float64),
                                ("cpu", "cpu", torch.float32),
                                ("cuda", "cuda", torch.float32)):
            p = tree_map(lambda t: t.to(dev, dtype), params)
            s = tree_map(lambda t: t.to(dev, dtype), state)
            batch_d = {"images": torch.as_tensor(b["images"], device=dev,
                                                 dtype=dtype),
                       "labels": torch.as_tensor(b["labels"], device=dev)}
            req = [t.clone().requires_grad_(True) for t in tree_leaves(p)]
            ts = time.perf_counter()
            loss, (new_state, _) = cnn.loss_fn(tree_unflatten(p, req), s, cfg,
                                               batch_d, train=True)
            grads = torch.autograd.grad(loss, req)
            sync(dev)
            out[key] = ([loss.detach().reshape(1)] + list(grads)
                        + tree_leaves(new_state), time.perf_counter() - ts)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
    path_of = {id(t): p for tree in (params, state)
               for p, t in tree_flatten_with_path(tree)}
    names = (["loss"] + [f"grad {path_of[id(t)]}" for t in tree_leaves(params)]
             + [f"state {path_of[id(t)]}" for t in tree_leaves(state)])
    rows = []
    for n, x64, x32, xc in zip(names, out["cpu64"][0], out["cpu"][0],
                               out["cuda"][0]):
        x64 = x64.double()
        scale = max(x64.abs().max().item(), 1e-30)
        e_cpu = (x32.double() - x64).abs().max().item()
        e_card = (xc.cpu().double() - x64).abs().max().item()
        rows.append((e_card / (2 * e_cpu + 1e-5 * scale), n, e_card / scale,
                     e_cpu / scale))
    rows.sort()
    for ratio, n, e_card, e_cpu in rows[-4:]:
        print(f"  resnet18 {n}: card {e_card:.3e}, cpu f32 {e_cpu:.3e} of "
              f"its scale off float64 (ratio to tolerance {ratio:.3f})")
    worst = rows[-1]
    loss64, loss_card = out["cpu64"][0][0].item(), out["cuda"][0][0].item()
    print(f"check resnet18 step card vs cpu (batch {batch}, f32, TF32 off): "
          f"loss {loss_card:.7f} vs float64 {loss64:.7f}; worst leaf "
          f"{worst[1]} at {worst[0]:.3f} of its tolerance (2x the CPU "
          "float32 error + 1e-5 of scale)")
    require(worst[0] <= 1.0, "resnet18 loss, gradients or BN state on the "
            "card are further from float64 than float32 rounding allows")
    return {"batch": batch, "loss_card": loss_card, "loss_cpu64": loss64,
            "worst_leaf": worst[1], "worst_ratio_to_tolerance": worst[0],
            "worst_card_rel_err": max(r[2] for r in rows),
            "worst_cpu_f32_rel_err": max(r[3] for r in rows), "tf32": False,
            "step_s_card": out["cuda"][1], "step_s_cpu": out["cpu"][1],
            "leaves": len(rows)}


# ---------------------------------------------------------------------------
# the hybrid family: recurrentgemma-2b (RG-LRU + sliding-window
# attention) served and retrained at its published size; command-r-35b
# (LayerNorm) served at full width
# ---------------------------------------------------------------------------
# #1/#2 at recurrentgemma-2b's projections (q/o, the 256-wide KV head,
# the gelu gate and up, down) and command-r-35b's (q/o, k/v, the silu
# gate and up, down), at decode and retrain rows
RG_BSMM_SHAPES = ((2560, 2560), (2560, 256), (2560, 7680), (7680, 2560))
CR_BSMM_SHAPES = ((8192, 8192), (8192, 1024), (8192, 22528), (22528, 8192))
NEW_BSMM_ROWS = (8, 1024)
# seven prompts up to a window's length and one of two windows
HYBRID_LENGTHS = (5, 17, 64, 129, 200, 256, 300, 4096)
HYBRID_MAX_NEW = 32
HYBRID_CAPACITY = 4224
CR_LAYERS = 8               # command-r-35b's 40 layers cut (7.73 G params)
CR_MAX_NEW = 16


def build_planned_ticket(params, device, seed=1234):
    """One seeded ~25 %-live 128x128 tile bitmap for every planned
    projection (attention q/k/v/o, MLP up/gate/down) at every position
    of every segment, shared by the position's stacked layers; the
    RG-LRU's projections are never planned and carry no mask."""
    rng = np.random.default_rng(seed)
    segments = []
    for pos_trees in params["segments"]:
        seg = []
        for tree in pos_trees:
            entry = {}
            for group, keys in LLAMA_PROJECTIONS:
                if group not in tree:
                    continue
                entry[group] = {}
                for key in keys:
                    leaf = tree[group][key]
                    K, N = leaf.shape[-2:]
                    bm = torch.as_tensor(random_bitmap(rng, K, N),
                                         device=device)
                    m = bm.repeat_interleave(128, 0).repeat_interleave(128, 1)
                    entry[group][key] = m.expand(leaf.shape)
            seg.append(entry)
        segments.append(seg)
    return {"segments": segments}


def planned_products(plan, cfg) -> list:
    """(wrapper, TilePlan, layers) of every planned forward product: the
    MLP gate on the epilogue kernel (its activation), every other
    projection on bsmm; a segment position's plan serves its repeats."""
    from repro_torch.models.transformer import segments_of

    out = []
    for seg, seg_plan in zip(segments_of(cfg), plan):
        for entry in seg_plan:
            for group, keys in (entry or {}).items():
                for key, p in keys.items():
                    name = "bsmm_epilogue" if (group, key) == ("mlp", "gate") \
                        else "bsmm"
                    out.append((name, p, seg.reps))
    return out


def expected_routes(B, products, passes, names=BSMM_ROUTED) -> dict:
    """``bsmm_routes`` as the model implies it.  ``passes``: one (M,
    forwards of a plain projection, forwards of the gate, dx and dw
    each) per pass of M rows; each product of ``products`` is launched
    that many times a layer (bf16), on the route and split count its
    plan gives at M."""
    want = {n: {"launches_by_route": {k: 0 for k in getattr(B, n)
                                      .launches_by_route},
                "split_launches": 0} for n in names}
    for M, fwd, gate, back in passes:
        for name, p, layers in products:
            for kind, wrapper, n in (("fwd", name,
                                      gate if name == "bsmm_epilogue"
                                      else fwd),
                                     ("dx", "bsmm_dx", back),
                                     ("dw", "bsmm_dw", back)):
                if n == 0:
                    continue
                route, S = p.route_and_splits(kind, M, torch.bfloat16)
                want[wrapper]["launches_by_route"][route] += n * layers
                want[wrapper]["split_launches"] += n * layers * (S > 1)
    return want


def teacher_forced(params, cfg, req, rows, device) -> float:
    """The largest error, over a request's sampled positions, of the
    engine's logits rows (prefill's, then each decode step's) against
    ``forward`` (plain: no plan, the masked weights) over the prompt and
    the tokens fed back, relative to each row's max |logit|.  Past one
    window (where the model has one) the sequence is padded to whole
    windows (the two-chunk form needs them; causality keeps the pad out
    of earlier positions)."""
    from repro_torch.models import transformer as tfm

    n = len(req.prompt)
    toks = np.concatenate([req.prompt, np.asarray(req.tokens[:-1])])
    S = len(toks)
    W = cfg.local_window
    if W is not None and S > W:
        toks = np.pad(toks, (0, -S % W))
    with torch.inference_mode():
        lg, _ = tfm.forward(params, cfg, {"tokens": torch.as_tensor(
            toks[None].astype(np.int64), device=device)})
        want = lg[0, n - 1:n - 1 + len(req.tokens)].float()
        del lg
        got = torch.as_tensor(np.stack(rows), device=want.device)
        err = ((got - want).abs().amax(-1)
               / want.abs().amax(-1).clamp_min(1e-30)).max().item()
    return err


def serve_hybrid(cfg, device):
    """Serve 8 requests through ``ServeEngine`` on recurrentgemma-2b at
    its published width and depth (26 layers: 18 RG-LRU, 8 local
    attention with window 2048) with a ~25 % ticket on every planned
    projection: dense slots (a window's ring of 2048 rows, the RG-LRU
    state), exact-length prefill, 7 prompts of 5-300 tokens and one of
    4096 (two windows: the two-chunk prefill and the ring's wrap).
    Checks finishing, finite logits, flash attention once per local
    layer and prompt within a window (all ``wgmma``; never for the
    4096-token one), #1/#2's launches, routes and split launches held
    to the model, plan-vs-dense prefill, and the engine's logits of the
    long request and a short one held to a teacher-forced ``forward``;
    profiles one decode tick."""
    from repro_torch._bridge import apply_masks, tree_leaves
    from repro_torch.configs import LOCAL_ATTN
    from repro_torch.kernels import bsmm as B
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import Request, ServeEngine

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = tfm.init_params(gen, cfg, device=device)
    masks = build_planned_ticket(params, device)
    params = apply_masks(params, masks)
    sync(device)
    setup_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    eng = ServeEngine(params=params, cfg=cfg, masks=masks, batch_slots=8,
                      capacity=HYBRID_CAPACITY, device=device)
    require(not eng.paged, "the hybrid engine is paged")
    nonfinite = [0]
    sample = eng._sample_row

    def checked(row, rng):
        nonfinite[0] += int((~np.isfinite(row)).sum())
        return sample(row, rng)

    eng._sample_row = checked
    prng = np.random.default_rng(5)
    reqs = [Request(uid=i, prompt=prng.integers(1, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new_tokens=HYBRID_MAX_NEW)
            for i, n in enumerate(HYBRID_LENGTHS)]
    held_to_forward = (reqs[-1], reqs[3])      # 4096 tokens, 129 tokens
    rows = {r.uid: [] for r in held_to_forward}
    eng.logits_sink = lambda uid, row: (rows[uid].append(row.copy())
                                        if uid in rows else None)
    for r in reqs:
        eng.submit(r)

    reset_bsmm_routes(B, ("bsmm", "bsmm_epilogue"))
    FA.flash_attention.launches = 0
    FA.flash_attention.launches_by_route.update(wgmma=0, simt=0)
    step_ms = []
    t0 = time.perf_counter()
    while not eng.idle:
        before = eng.report.prefills
        ts = time.perf_counter()
        eng.step()
        sync(device)
        if eng.report.prefills == before:       # a decode-only tick
            step_ms.append((time.perf_counter() - ts) * 1e3)
    serve_s = time.perf_counter() - t0
    eng.logits_sink = None
    launches = {"bsmm": B.bsmm.launches,
                "bsmm_epilogue": B.bsmm_epilogue.launches,
                "flash_attention": FA.flash_attention.launches}
    routes = bsmm_routes(B, ("bsmm", "bsmm_epilogue"))
    rep = eng.report
    require(all(r.done and len(r.tokens) == HYBRID_MAX_NEW for r in reqs),
            "not every recurrentgemma request finished")
    require(nonfinite[0] == 0, f"{nonfinite[0]} non-finite logits")
    n_local = sum(k == LOCAL_ATTN for k in cfg.blocks)
    within = sum(len(r.prompt) <= cfg.local_window for r in reqs)
    require_flash_routes(FA, n_local * within, "recurrentgemma serving")
    # one pass a prefill (the prompt's own rows) or a decode step (8)
    want = expected_serving_routes(
        B, eng.plan, cfg, [8] * rep.decode_steps
        + [len(r.prompt) for r in reqs], ("bsmm", "bsmm_epilogue"))
    print(f"recurrentgemma serving: bsmm routes {routes}, want {want} "
          f"({rep.prefills} prefills, {rep.decode_steps} decode steps)")
    require(routes == want, "recurrentgemma's bsmm launches, routes or "
            "split launches do not match the model")
    require(all(launches[n] == sum(want[n]["launches_by_route"].values())
                for n in want), "bsmm launch counts disagree with routes")

    # block-sparse prefill through the plan vs dense prefill on the
    # masked weights, at one exact-length prompt
    n = len(reqs[3].prompt)
    with torch.inference_mode():
        batch = {"tokens": torch.as_tensor(reqs[3].prompt[None].astype(
            np.int64), device=device)}
        got, _ = tfm.prefill(params, cfg, batch, HYBRID_CAPACITY,
                             plan=eng.plan)
        want_l, _ = tfm.prefill(params, cfg, batch, HYBRID_CAPACITY)
    diff = (got.float() - want_l.float()).abs().max().item()
    scale = want_l.float().abs().max().item()
    tol = 5e-2 * scale
    print(f"check recurrentgemma plan prefill vs dense masked prefill "
          f"({cfg.dtype}, {cfg.n_layers} layers, exact length {n}): "
          f"max_abs_err={diff:.4e} max|logit|={scale:.4e} tol={tol:.4e}")
    require(bool(torch.isfinite(got).all().item()), "plan prefill non-finite")
    require(diff <= tol, "recurrentgemma plan prefill disagrees with dense "
            "prefill")
    del got, want_l
    teacher = {}
    for r in held_to_forward:
        teacher[len(r.prompt)] = teacher_forced(params, cfg, r, rows[r.uid],
                                                device)
        print(f"check recurrentgemma teacher-forced forward vs engine "
              f"logits (prompt {len(r.prompt)}, {len(r.tokens)} positions): "
              f"max err {teacher[len(r.prompt)]:.4e} of each row's "
              f"max|logit| (tol {TEACHER_TOL})")
        require(teacher[len(r.prompt)] <= TEACHER_TOL,
                f"the engine's logits of the {len(r.prompt)}-token request "
                "disagree with the teacher-forced forward")
    del rows
    step_ms.sort()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    profile = profile_decode(eng, cfg, device, "recurrentgemma") \
        if on_card else None
    summary = {
        "config": cfg.name, "n_layers": cfg.n_layers, "parameters": n_params,
        "setup_s": setup_s, "serve_s": serve_s,
        "decode_only_steps": len(step_ms),
        "decode_step_ms_p50": step_ms[len(step_ms) // 2] if step_ms else None,
        "decode_step_ms_min": step_ms[0] if step_ms else None,
        "tokens_per_s": rep.tokens_per_s,
        "ttft_p50_s": rep.ttft_p50, "ttft_p95_s": rep.ttft_p95,
        "ttft_4096_s": reqs[-1].ttft,
        "max_memory_allocated_bytes": peak,
        "skipped_tile_fraction": rep.skipped_tile_fraction,
        "launches": launches, "bsmm_routes": routes,
        "flash_launches_per_prefill_within_window": n_local,
        "prefill_plan_vs_dense_max_abs_err": diff,
        "prefill_plan_vs_dense_tol": tol,
        "teacher_forced_rel_err": teacher,
        "decode_profile": profile,
        "report": rep.__dict__,
    }
    print("recurrentgemma serve: " + json.dumps(
        {k: summary[k] for k in ("parameters", "decode_step_ms_p50",
                                 "decode_step_ms_min", "tokens_per_s",
                                 "ttft_p50_s", "ttft_p95_s", "ttft_4096_s",
                                 "max_memory_allocated_bytes")}))
    return launches, summary


def retrain_lm(device, steps: int = 4, arch="recurrentgemma-2b",
               seq_len: int = 128, ticket_seed=None):
    """``make_adapter(arch, scale="full").make_trainer(params,
    masks).run(1)`` ``steps`` times at 8 x ``seq_len`` tokens (1024 rows:
    #1-#4 on ``wgmma``; a vlm config's batches carry its patch prefix
    too, 8 x (576 + 448) = 8192 rows for phi-3-vision), on a seeded
    ~25 % ticket of every planned projection (``build_planned_ticket``)
    or, with ``ticket_seed``, of every leaf the family's predicate prunes
    (``family_ticket``: xlstm-125m, whose projections are never planned):
    finite losses and parameters, pruned coordinates exactly zero, and
    #1-#4's launches, routes and split launches per step held to the
    model (r forwards of each plain projection, r + 1 of the gate, one
    dx and one dw of each; r = 2 with remat; recurrent projections
    dense, so none at all for xlstm); the median step, the peak memory
    and one profiled step."""
    from repro_torch._bridge import tree_leaves
    from repro_torch.api import make_adapter
    from repro_torch.kernels import bsmm as B
    from repro_torch.models import transformer as tfm
    from repro_torch.train import lm_train_plan

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    adapter = make_adapter(arch, scale="full", batch_size=8, seq_len=seq_len,
                           device=device)
    cfg = adapter.cfg
    name = cfg.name
    params = adapter.init_params(
        torch.Generator(device=device).manual_seed(0))
    masks = (build_planned_ticket(params, device) if ticket_seed is None
             else family_ticket(params, adapter.prunable, device,
                                ticket_seed))
    trainer = adapter.make_trainer(params, masks, learning_rate=1e-4)
    del params
    sync(device)
    setup_s = time.perf_counter() - t0
    reset_bsmm_routes(B)
    losses, step_s = [], []
    for _ in range(steps):
        ts = time.perf_counter()
        m = trainer.run(1)
        step_s.append(time.perf_counter() - ts)
        losses.append(m["loss"])
    routes = bsmm_routes(B)
    launches = {n: getattr(B, n).launches for n in BSMM_ROUTED}
    peak = torch.cuda.max_memory_allocated() if on_card else None
    r = 2 if tfm.remat_enabled() else 1
    rows = 8 * (seq_len + cfg.num_patch_tokens)
    plan = lm_train_plan(masks)[0]
    products = planned_products(plan, cfg) if plan is not None else []
    want = expected_routes(B, products, [(rows, r, r + 1, 1)] * steps)
    print(f"retrain {name}: remat={tfm.remat_enabled()} losses={losses} "
          f"launches {launches}, routes {routes}, want {want}")
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    require(routes == want, f"{name}'s bsmm launches, routes or split "
            "launches in retraining do not match the model")
    require(all(launches[n] == sum(want[n]["launches_by_route"].values())
                for n in want), "bsmm launch counts disagree with routes")
    require_ticket_held(trainer.state.params, masks, f"retrain {name}")
    mid = sorted(step_s[1:])
    step_med = mid[len(mid) // 2]
    profile = profile_step(trainer) if on_card else None
    per_step = {n: launches[n] // steps for n in BSMM_ROUTED}
    summary = {
        "config": cfg.name, "n_layers": cfg.n_layers,
        "parameters": sum(t.numel() for t in
                          tree_leaves(trainer.state.params)),
        "setup_s": setup_s, "steps": steps, "remat": tfm.remat_enabled(),
        "step_s": step_s, "step_s_median_2_to_4": step_med,
        "rows": rows, "tokens_per_s": 8 * seq_len / step_med,
        "losses": losses,
        "max_memory_allocated_bytes": peak,
        "launches_per_step": per_step, "bsmm_routes": routes,
        "live_tiles": adapter.last_plan_stats.live_tiles,
        "total_tiles": adapter.last_plan_stats.total_tiles,
        "profile": profile}
    print(f"retrain {name}: " + json.dumps(
        {k: summary[k] for k in ("step_s_median_2_to_4", "tokens_per_s",
                                 "max_memory_allocated_bytes",
                                 "launches_per_step")}))
    return launches, summary


def command_r_config():
    """command-r-35b at its published widths with one cut: 40 layers to
    8 (the full 30.3 G parameters would take 60.6 GB of the card's 80
    before any KV pool)."""
    import dataclasses

    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("command-r-35b"),
                               n_layers=CR_LAYERS)


# ---------------------------------------------------------------------------
# the last four families: xlstm-125m (ssm), whisper-tiny (audio, the
# frames lane), phi-3-vision (vlm: patch prefix) and llama4-maverick
# ---------------------------------------------------------------------------
# xlstm's prompts include one of exactly 256 (two whole chunks: the
# chunkwise mLSTM) beside ragged ones (sequential)
XLSTM_LENGTHS = (5, 17, 64, 127, 129, 200, 256, 300)
WHISPER_LENGTHS = (4, 9, 17, 24, 33, 40, 57, 64)
WHISPER_CAPACITY = 128
VLM_RETRAIN_LAYERS = 8      # phi-3-vision's 32 layers cut (1.11 G params)
# text tokens a retrain row: 576 patches + 448 = 1024 positions, since the
# training attention (as the reference's) takes a sequence of at most
# 512 or a multiple of 512, and 576 + 128 = 704 is neither
VLM_SEQ = 448
LLAMA4_LAYERS = 4           # one period of (local x 3, global), MoE on 1, 3
LLAMA4_EXPERTS = 64         # of 128 (18.94 G params, ~37.9 GB in bf16)
# #1/#2 at llama4-maverick's projections (q/o, k/v, the dense FFN's and
# the shared expert's silu gate and up, down) at decode rows and at
# prompts (ragged, the longest), and #1b at its experts over 64 at each
# expert capacity its serving passes give (``llama4_capacities``)
LLAMA4_BSMM_SHAPES = ((5120, 5120), (5120, 1024), (5120, 8192), (8192, 5120))
LLAMA4_BSMM_ROWS = (8, 129, 300)
LLAMA4_EXPERT_SHAPES = ((5120, 8192), (8192, 5120))
# #1-#4 at phi-3-vision's retrain rows, 8 x (576 patches + 448 tokens)
VLM_BSMM_SHAPES = ((3072, 3072), (3072, 8192), (8192, 3072))
VLM_RETRAIN_ROWS = (8 * (576 + VLM_SEQ),)


def family_ticket(params, prunable, device, seed):
    """A seeded ~25 %-live crossbar ticket for a family whose projections
    are never planned: one 128x128 tile bitmap per leaf the family's
    predicate prunes (ragged edge tiles cropped), shared along the
    leaf's leading axes as an expanded view; None elsewhere."""
    from repro_torch.core.masks import tree_map_with_path

    rng = np.random.default_rng(seed)

    def mk(path, leaf):
        if not prunable(path, leaf):
            return None
        K, N = leaf.shape[-2:]
        bm = rng.random((-(-K // 128), -(-N // 128))) < LIVE_FRACTION
        m = torch.as_tensor(bm, device=device).repeat_interleave(128, 0) \
            .repeat_interleave(128, 1)[:K, :N]
        return m.expand(leaf.shape)

    return tree_map_with_path(mk, params)


def masked_leaves(params, masks):
    """(parameter, mask) for every masked leaf of a ticket whose mask
    tree mirrors the parameters (None or absent where unmasked)."""
    if masks is None:
        return
    if isinstance(masks, dict):
        for k, m in masks.items():
            yield from masked_leaves(params[k], m)
    elif isinstance(masks, (list, tuple)):
        for p, m in zip(params, masks):
            yield from masked_leaves(p, m)
    else:
        yield params, masks


def require_ticket_held(params, masks, where: str) -> None:
    """Every parameter finite and every pruned coordinate exactly 0."""
    from repro_torch._bridge import tree_leaves

    require(all(bool(torch.isfinite(p).all().item())
                for p in tree_leaves(params)),
            f"{where}: a parameter is non-finite")
    for p, m in masked_leaves(params, masks):
        require(not bool(((p != 0) & ~m.bool()).any().item()),
                f"{where}: a pruned coordinate is non-zero")


def teacher_forced_encdec(params, cfg, req, rows, device) -> float:
    """``teacher_forced`` for an encoder-decoder: ``encdec.forward`` on
    the request's frames over the prompt and the tokens fed back."""
    from repro_torch.models import encdec

    n = len(req.prompt)
    toks = np.concatenate([req.prompt, np.asarray(req.tokens[:-1])])
    with torch.inference_mode():
        lg, _ = encdec.forward(params, cfg, {
            "frames": torch.as_tensor(np.asarray(req.frames, np.float32)[None],
                                      device=device),
            "tokens": torch.as_tensor(toks[None].astype(np.int64),
                                      device=device)})
        want = lg[0, n - 1:n - 1 + len(req.tokens)].float()
        return rel_row_err(rows, want)


def serve_xlstm(device, cfg=None, **kw):
    """``serve`` on xlstm-125m at its published width and depth (12
    layers, mLSTM and sLSTM alternating), prompts of 5-300 tokens with
    one of exactly 256 (two whole chunks: the chunkwise mLSTM), dense
    slots, a seeded ~25 % crossbar ticket on every leaf the ssm
    predicate prunes (never planned: dense products on the masked
    weights, so no kernel launches), every request's logits held to a
    teacher-forced ``forward``."""
    from repro_torch.configs import get_arch
    from repro_torch.core.masks import family_prunable

    cfg = cfg or get_arch("xlstm-125m")
    kw = {"lengths": XLSTM_LENGTHS, **kw}
    return serve(cfg, device, label="xlstm", prompt_seed=6, planned=False,
                 teacher="all", ticket=lambda p: family_ticket(
                     p, family_prunable(cfg.family), device, 31), **kw)


def serve_whisper(device, cfg=None, cli_check=True, **kw):
    """``serve`` through the engine's frames lane on whisper-tiny at its
    published width and depth (4 encoder and 4 decoder layers, 1500
    frames), each request with ``EncDecAdapter.serve_frames(uid)`` and a
    prompt of 4-64 tokens, a seeded ~25 % crossbar ticket from the audio
    predicate (dense products on the masked weights): #8 a request 4
    times full at S = 1500 and 4 times causal, every request's logits
    held to a teacher-forced ``encdec.forward``; then ``api.cli serve
    --arch whisper-tiny --scale full`` in process."""
    import io

    from repro_torch.api import cli, make_adapter

    adapter = make_adapter(cfg or "whisper-tiny", scale="full", device=device)
    kw = {"lengths": WHISPER_LENGTHS, "capacity": WHISPER_CAPACITY, **kw}
    launches, summary = serve(
        adapter.cfg, device, label="whisper", prompt_seed=7, adapter=adapter,
        planned=False, teacher="all", ticket=lambda p: family_ticket(
            p, adapter.prunable, device, 33), **kw)
    if cli_check:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            code = cli.main(["serve", "--arch", "whisper-tiny", "--scale",
                             "full", "--device", str(device), "--requests",
                             "4", "--json"])
        row = json.loads(out.getvalue().strip().splitlines()[-1])
        print(f"cli serve whisper-tiny: exit {code}, {json.dumps(row)[:300]}")
        require(code == 0 and row["event"] == "serve"
                and row["requests"] == 4, "cli serve whisper-tiny failed")
        summary["cli"] = {**row, "exit": code, "s": time.perf_counter() - t0}
    return launches, summary


def serve_vlm(device, cfg=None, **kw):
    """``serve`` on phi-3-vision at its published width and depth (32
    layers, 32 query and KV heads of 96), text-only prompts, paged,
    exact-length prefill (the patch prefix rules out masked rows), a
    seeded ~25 % ticket on every planned projection: #6 and #8 at head
    width 96, every request's logits held to a teacher-forced
    ``forward``."""
    from repro_torch.configs import get_arch

    return serve(cfg or get_arch("phi-3-vision-4.2b"), device,
                 label="phi-3-vision", prompt_seed=8, teacher="all",
                 ticket=lambda p: build_planned_ticket(p, device, seed=35),
                 **kw)


def llama4_ticket(params, device):
    """A seeded ~25 % ticket on every attention projection
    (``build_planned_ticket``) and on the dense FFN, the experts and the
    shared expert (``build_expert_ticket``)."""
    attn = build_planned_ticket(params, device, seed=36)
    ffn = build_expert_ticket(params, device)
    return {"segments": [[{**({"attn": a["attn"]} if "attn" in a else {}),
                           **f} for a, f in zip(seg_a, seg_f)]
                         for seg_a, seg_f in zip(attn["segments"],
                                                 ffn["segments"])]}


def serve_llama4(device, cfg=None, **kw):
    """``serve`` on the cut llama4-maverick (``llama4_config``), dense
    slots (local windows), 16-32 new tokens a request,
    ``llama4_ticket``: #1/#2 and #1b on their routes, each prefill row
    held to ``forward`` without a plan (``prefill_rows_check``)."""
    kw = {"max_new": [16 + (i * 16) // 7 for i in range(8)], **kw}
    return serve(cfg or llama4_config(), device, label="llama4",
                 prompt_seed=10, teacher="prefill",
                 ticket=lambda p: llama4_ticket(p, device), **kw)


@contextlib.contextmanager
def trainer_losses():
    """Within it, every step's loss as ``train.loop.Trainer`` logs it (at
    ``log_every=1``) goes into the yielded list."""
    import logging

    losses = []
    log = logging.getLogger("train")
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda rec: losses.append(float(rec.args[1]))
    level = log.level
    log.setLevel(logging.INFO)
    log.addHandler(handler)
    try:
        yield losses
    finally:
        log.removeHandler(handler)
        log.setLevel(level)


def retrain_whisper(device, cfg=None, steps: int = 4):
    """``EncDecAdapter(cfg).train(params, masks, steps)`` on whisper-tiny
    at its published size, 8 rows of 128 tokens over 1500 frames, with
    a seeded ~25 % crossbar ticket from the audio predicate, after one
    warm-up step: every step's loss finite (the warm-up's too), the
    parameters finite and moved by the steps, pruned coordinates
    exactly zero; the mean step and the peak memory."""
    from repro_torch._bridge import tree_leaves
    from repro_torch.api import EncDecAdapter
    from repro_torch.configs import get_arch

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    adapter = EncDecAdapter(cfg or get_arch("whisper-tiny"), batch_size=8,
                            seq_len=128, device=device, log_every=1)
    params = adapter.init_params(torch.Generator(device=device).manual_seed(0))
    masks = family_ticket(params, adapter.prunable, device, 34)
    with trainer_losses() as losses:
        t0 = time.perf_counter()
        params = adapter.train(params, masks, steps=1)
        warm_s = time.perf_counter() - t0
        start = [t.clone() for t in tree_leaves(params)]
        t0 = time.perf_counter()
        params = adapter.train(params, masks, steps=steps)
        train_s = time.perf_counter() - t0
    moved = sum((a.float() - b.float()).abs().sum().item()
                for a, b in zip(tree_leaves(params), start))
    del start
    print(f"retrain whisper: losses {losses} (warm-up first), {steps} steps "
          f"in {train_s:.2f} s (warm-up step {warm_s:.2f} s), sum |dparams| "
          f"{moved:.4e}")
    require(len(losses) == steps + 1 and all(np.isfinite(losses)),
            f"whisper losses {losses}: not one finite loss a step")
    require(moved > 0, "whisper's parameters did not move in retraining")
    require_ticket_held(params, masks, "retrain whisper")
    summary = {"config": adapter.cfg.name, "rows": 8, "tokens": 128,
               "frames": adapter.cfg.encoder_seq_len, "steps": steps,
               "warmup_step_s": warm_s, "step_s_mean": train_s / steps,
               "tokens_per_s": 8 * 128 * steps / train_s, "losses": losses,
               "params_moved_abs_sum": moved,
               "max_memory_allocated_bytes":
               torch.cuda.max_memory_allocated() if on_card else None}
    print("retrain whisper: " + json.dumps(summary))
    return summary


def vlm_retrain_config():
    """phi-3-vision at its published widths with one cut, 32 layers to 8
    (1.11 G parameters): at full depth (3.83 G) AdamW's state and the
    1024-position rows would not fit beside each other."""
    import dataclasses

    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("phi-3-vision-4.2b"),
                               n_layers=VLM_RETRAIN_LAYERS)


def llama4_capacities(cfg=None) -> tuple:
    """The expert capacities (rows an expert) of the cut llama4's serving
    passes: a decode step's 8 tokens and each prompt's."""
    from repro_torch.models.moe import expert_capacity

    moe = (cfg or llama4_config()).moe
    return tuple(sorted({expert_capacity(T, moe)
                         for T in (8,) + SERVE_LENGTHS}))


def llama4_config():
    """llama4-maverick at its published widths with two cuts: 48 layers
    to 4 (one period of local, local, local, global attention; MoE on
    layers 1 and 3) and 128 routed experts to 64."""
    import dataclasses

    from repro_torch.configs import get_arch
    cfg = get_arch("llama4-maverick-400b-a17b")
    return dataclasses.replace(
        cfg, n_layers=LLAMA4_LAYERS,
        moe=dataclasses.replace(cfg.moe, num_experts=LLAMA4_EXPERTS))


# ---------------------------------------------------------------------------
# The sparsity lint on the card: its kernel cases held to their kernels,
# a full-width llama3.2-3b linted through its real launches, and the
# tiny --all lint on the card against the CPU's
# ---------------------------------------------------------------------------
#: llama3.2-3b at full width for leg (b), 28 layers cut to this many:
#: the lint's structured prune scores every prunable weight on the host,
#: and at full depth leg (b) took 148.0 s on the H100's machine (119.5 s
#: of it that prune, 16.3 s the mask accounting), past the phase's 120 s
LINT_LAYERS = 4
#: the kernel wrappers the lint path's launches are read from
LINT_COUNTED = BSMM_ROUTED + BATCHED_ROUTED
#: a case's kernel (the kernel table's number) -> its kernels-line name
LINT_KERNEL_NAMES = {"#1": "bsmm", "#2": "bsmm_epilogue", "#3": "bsmm_dx",
                     "#4": "bsmm_dw", "#1b": "bsmm_batched",
                     "#3b": "bsmm_batched_dx", "#4b": "bsmm_batched_dw",
                     "#5": "masked_matmul", "#6": "paged_attention",
                     "#7": "paged_attention_fused_v",
                     "#8": "flash_attention", "#9": "tile_stats"}


@contextlib.contextmanager
def nan_outputs(B):
    """Every floating tensor ``torch.empty`` makes while active starts as
    NaN, and so does bsmm's persistent split workspace (its counters stay
    0): an output element or partial a kernel fails to write stays NaN."""
    real = torch.empty

    def empty(*a, **k):
        t = real(*a, **k)
        if t.is_floating_point():
            t.fill_(float("nan"))
        return t

    with torch.inference_mode():     # made there by the earlier phases
        for ws, _ in B._SCRATCH.values():
            ws.fill_(float("nan"))
    torch.empty = empty
    try:
        yield
    finally:
        torch.empty = real


def reset_lint_counts(B, FA, PA, TS) -> None:
    """Every wrapper's launch, route and split counts to 0."""
    reset_bsmm_routes(B, LINT_COUNTED)
    for f in (B.masked_matmul,):
        f.launches = f.split_launches = 0
        f.launches_by_route.update({k: 0 for k in f.launches_by_route})
    PA.paged_attention.launches = 0
    PA.paged_attention.fused_launches = 0
    PA.paged_attention.fused_launches_by_route.update(wgmma=0, simt=0)
    FA.flash_attention.launches = 0
    FA.flash_attention.launches_by_route.update(wgmma=0, simt=0)
    TS.tile_stats.launches = 0


def lint_counts(B, FA, PA, TS) -> dict:
    """Launches of every kernel of the kernels line, by its name there."""
    out = {n: getattr(B, n).launches for n in LINT_COUNTED}
    out.update(masked_matmul=B.masked_matmul.launches,
               paged_attention=PA.paged_attention.launches,
               paged_attention_fused_v=PA.paged_attention.fused_launches,
               flash_attention=FA.flash_attention.launches,
               tile_stats=TS.tile_stats.launches)
    return out


def _route_counter(B, FA, PA, TS, spec):
    """(the wrapper's count by route, its split count) a case's launch
    moves."""
    if spec.kernel in ("#6",):
        return lambda: (PA.paged_attention.launches, 0)
    if spec.kernel == "#7":
        return lambda: (PA.paged_attention.fused_launches_by_route[
            spec.route], 0)
    if spec.kernel == "#8":
        return lambda: (FA.flash_attention.launches_by_route[spec.route], 0)
    if spec.kernel == "#9":
        return lambda: (TS.tile_stats.launches, 0)
    f = getattr(B, spec.name)
    return lambda: (f.launches_by_route[spec.route], f.split_launches)


def _case_call(case, B, FA, PA, TS, g, device):
    """(kernel call, plain call) of a default case on the card, with NaN
    under every dead tile of a weight (#1-#3, #1b, #3b) and in every
    pool row past a length or off the table (#6, #7)."""
    from repro_torch.analysis.kernel_audit import bitmap_mask, paged_case
    from repro_torch.kernels.bsmm import make_tile_plan
    i = case.inputs
    kind = i["kind"]
    nan = float("nan")

    def rnd(*shape, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=device) * 0.5) \
            .to(dtype).contiguous()

    if kind in ("fwd", "dx", "dw", "batched", "batched_dx", "batched_dw"):
        mask = bitmap_mask(i["bitmap"])
        plan = make_tile_plan(mask, strict=True)
        K, N = mask.shape
        dt, M, E = i["dtype"], i["M"], i.get("E", 1)
        dead = torch.from_numpy(mask == 0).to(device)
        w = rnd(E, K, N, dtype=dt)
        if kind not in ("dw", "batched_dw"):
            w[:, dead] = nan                      # never read, never reaches
        w2 = w[0].contiguous()
        if kind == "fwd":
            x = rnd(M, K, dtype=dt)
            if i["epilogue"]:
                bias = rnd(N, dtype=dt)
                return (lambda: B.bsmm_epilogue(x, w2, plan, bias, "silu"),
                        lambda: B.bsmm_epilogue_plain(x, w2, plan, bias,
                                                      "silu"))
            return (lambda: B.bsmm(x, w2, plan),
                    lambda: B.bsmm_plain(x, w2, plan))
        if kind == "dx":
            gr = rnd(M, N, dtype=dt)
            return (lambda: B.bsmm_dx(gr, w2, plan),
                    lambda: B.bsmm_dx_plain(gr, w2, plan))
        if kind == "dw":
            x, gr = rnd(M, K, dtype=dt), rnd(M, N, dtype=dt)
            return (lambda: B.bsmm_dw(x, gr, plan),
                    lambda: B.bsmm_dw_plain(x, gr, plan))
        if kind == "batched":
            a = rnd(E, M, K, dtype=dt)
            return (lambda: B.bsmm_batched(a, w, plan),
                    lambda: B.bsmm_batched_plain(a, w, plan))
        if kind == "batched_dx":
            gr = rnd(E, M, N, dtype=dt)
            return (lambda: B.bsmm_batched_dx(gr, w, plan),
                    lambda: B.bsmm_batched_dx_plain(gr, w, plan))
        x, gr = rnd(E, M, K, dtype=dt), rnd(E, M, N, dtype=dt)
        return (lambda: B.bsmm_batched_dw(x, gr, plan),
                lambda: B.bsmm_batched_dw_plain(x, gr, plan))
    if kind == "masked":
        dt = i["dtype"]
        x, w = rnd(i["M"], i["K"], dtype=dt), rnd(i["K"], i["N"], dtype=dt)
        m = (torch.rand(i["K"], i["N"], generator=g, device=device) < 0.3) \
            .to(dt)
        m[:128, :128] = 0                         # an all-dead tile
        return (lambda: B.masked_matmul(x, w, m, bm=8),
                lambda: B.masked_matmul_plain(x, w, m))
    if kind == "paged":
        geo, tables, lengths, blocks, dt, fused = paged_case(i["route"])
        q = rnd(geo.B, geo.Hq, geo.hd, dtype=dt)
        kp = rnd(geo.P, geo.T, geo.Hkv, geo.hd, dtype=dt)
        vp = None if fused else rnd(geo.P, geo.T, geo.Hkv, geo.dv, dtype=dt)
        live = torch.zeros(geo.P, geo.T, dtype=torch.bool, device=device)
        for b, blks in enumerate(blocks):
            for j, p in enumerate(blks):
                live[p, :min(geo.T, lengths[b] - j * geo.T)] = True
        for pool in (kp, vp):
            if pool is not None:
                pool[~live] = nan                 # past a length, off-table
        tb = torch.as_tensor(tables, device=device)
        ln = torch.as_tensor(lengths, dtype=torch.int32, device=device)
        kw = dict(scale=geo.hd ** -0.5, v_dim=geo.dv if fused else None)
        return (lambda: PA.paged_attention(q, kp, vp, tb, ln, **kw),
                lambda: PA.paged_attention_ref(q, kp, vp, tb, ln, **kw))
    if kind == "flash":
        from repro_torch.analysis.kernel_audit import FLASH as F_
        dt = i["dtype"]
        q = rnd(F_["B"], F_["S"], F_["Hq"], F_["hd"], dtype=dt)
        k = rnd(F_["B"], F_["S"], F_["Hkv"], F_["hd"], dtype=dt)
        v = rnd(F_["B"], F_["S"], F_["Hkv"], F_["dv"], dtype=dt)
        return (lambda: FA.flash_attention(q, k, v, causal=True),
                lambda: FA.flash_attention_plain(q, k, v, causal=True))
    w = rnd(i["K"], i["N"])
    w[:128, :128] = 0
    return (lambda: TS.tile_stats(w)[1], lambda: TS.tile_stats_plain(w)[1])


def _library_smem(spec, B, FA, PA) -> int:
    """The shared memory the kernel's own library says a wgmma launch of
    this spec asks for."""
    import ctypes
    if spec.kernel == "#5":
        return B.masked_wgmma_smem_bytes(torch.bfloat16)
    if spec.kernel == "#8":
        op = spec.operands
        return FA.wgmma_smem_bytes(op["q"][1] // spec.grid[1],
                                   op["out"][1] // spec.grid[1])
    if spec.kernel == "#7":
        lib = PA._lib()
        lib.paged_attention_fused_wgmma_smem.argtypes = [ctypes.c_int]
        lib.paged_attention_fused_wgmma_smem.restype = ctypes.c_int
        hd = spec.operands["q"][1]
        got = lib.paged_attention_fused_wgmma_smem(hd)
        require(got == PA.fused_wgmma_smem_bytes(hd),
                "the fused kernel's shared memory disagrees with "
                "fused_wgmma_smem_bytes")
        return got
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return B.wgmma_smem_bytes(int(np.prod(spec.grid)) <= sms)


def lint_kernel_cases(B, FA, PA, TS, device="cuda") -> dict:
    """Leg (a): ``lint --kernels`` clean, then every default case's kernel
    launched once with NaN-filled outputs and workspaces (and NaN under
    dead tiles and past lengths), its spec's region finite, nothing
    outside it written (dw's dead tiles stay the wrapper's zeros), the
    result held to the plain version, the launch on the spec's route and
    split, and a wgmma case's shared memory the library's figure."""
    from repro_torch.analysis import lint_kernels
    from repro_torch.analysis.kernel_audit import default_cases
    rep = lint_kernels()
    require(rep.ok and not rep.findings,
            f"lint --kernels on the card: {[str(f) for f in rep.findings]}")
    g = torch.Generator(device=device).manual_seed(41)
    rows = {}
    for case in default_cases():
        spec = case.spec
        call, plain = _case_call(case, B, FA, PA, TS, g, device)
        count = _route_counter(B, FA, PA, TS, spec)
        before = count()
        with nan_outputs(B):
            out = call()
        torch.cuda.synchronize()
        after = count()
        require(after[0] == before[0] + 1,
                f"{case.name}: no launch on the {spec.route} route")
        if spec.kernel in ("#1", "#2", "#1b", "#3", "#3b", "#4", "#4b"):
            require(after[1] - before[1] == (spec.splits > 1),
                    f"{case.name}: split launches disagree with the spec")
        want = plain()
        o2 = out.reshape(spec.operands[spec.output]).float()
        region = torch.from_numpy(spec.region).to(device)
        require(bool(torch.isfinite(o2[region]).all()),
                f"{case.name}: an element the spec writes is not finite")
        if not spec.region.all():
            require(bool((o2[~region] == 0).all()),
                    f"{case.name}: written outside the spec's region")
        err = float((out.float() - want.float()).abs().max())
        tol = tolerance(out.dtype, want)
        require(err <= tol, f"{case.name}: |kernel - plain| = {err} > {tol}")
        smem = None
        if spec.route == "wgmma":
            smem = _library_smem(spec, B, FA, PA)
            require(smem == spec.smem,
                    f"{case.name}: spec smem {spec.smem} != library {smem}")
        rows[case.name] = {"kernel": spec.kernel, "route": spec.route,
                           "splits": spec.splits, "launches": after[0]
                           - before[0], "max_abs_err": err, "smem": smem}
        print(f"lint case {case.name}: {rows[case.name]}")
    return rows


def lint_phase(B, FA, PA, TS, device="cuda") -> tuple:
    """The lint on the card: leg (a) the kernel cases; then, with every
    count set to 0, leg (b) ``lint_arch`` on llama3.2-3b at full width
    (cut to ``LINT_LAYERS`` layers) with 0 errors and real launches in
    each audited closure, with ``--hlo``: the meshless engine's traced
    prefill has no J206 and no J207; and leg (c) the tiny ``lint --all``
    on the card equal to the CPU's, arch by arch.  Returns (launches of
    the lint path, summary)."""
    import dataclasses

    from repro_torch.analysis import lint_arch
    from repro_torch.api.registry import list_adaptable
    from repro_torch.configs import get_arch

    t0 = time.perf_counter()
    cases = lint_kernel_cases(B, FA, PA, TS, device)
    t_a = time.perf_counter() - t0

    reset_lint_counts(B, FA, PA, TS)
    per_closure = {}

    @contextlib.contextmanager
    def probe(where):
        before = {**bsmm_routes(B, BSMM_ROUTED),
                  "paged_attention": PA.paged_attention.launches,
                  "flash_attention": dict(FA.flash_attention
                                          .launches_by_route)}
        yield
        torch.cuda.synchronize()
        now = {**bsmm_routes(B, BSMM_ROUTED),
               "paged_attention": PA.paged_attention.launches,
               "flash_attention": dict(FA.flash_attention.launches_by_route)}
        grew = {}
        for n in BSMM_ROUTED:
            b, a = before[n]["launches_by_route"], now[n]["launches_by_route"]
            grew[n] = {r: a[r] - b[r] for r in a if a[r] - b[r]}
        grew["paged_attention"] = now["paged_attention"] \
            - before["paged_attention"]
        grew["flash_attention"] = {
            r: now["flash_attention"][r] - before["flash_attention"][r]
            for r in now["flash_attention"]}
        per_closure[where.split("/", 1)[1]] = grew

    t1 = time.perf_counter()
    cfg = dataclasses.replace(get_arch("llama3.2-3b"), n_layers=LINT_LAYERS)
    rep = lint_arch(cfg, scale="full", device=device, probe=probe, hlo=True)
    t_b = time.perf_counter() - t1
    hlo = sorted((f.code, f.where) for f in rep.findings
                 if f.code in ("J206", "J207"))
    print(f"lint --hlo llama3.2-3b full width: J206/J207 findings {hlo}")
    require(hlo == [], "the meshless engine's traced prefill has J206 or "
            "J207 findings")
    print(f"lint llama3.2-3b full width, {LINT_LAYERS} layers: "
          f"{rep.summary()} in {t_b:.1f} s; per closure {per_closure}")
    require(rep.ok, f"the full-width lint: {[str(f) for f in rep.errors]}")
    fwd = lambda c, r: sum(per_closure[c][n].get(r, 0)      # noqa: E731
                           for n in ("bsmm", "bsmm_epilogue"))
    require(fwd("prefill", "wgmma") > 0
            and per_closure["prefill"]["flash_attention"]["wgmma"] > 0,
            "the audited prefill launched no wgmma bsmm or flash kernel")
    require(fwd("decode", "stream") > 0,
            "the audited decode launched no stream bsmm kernel")
    require(per_closure["decode_paged"]["paged_attention"] > 0,
            "the audited paged decode launched no paged kernel")
    require(sum(per_closure["train_step"]["bsmm_dx"].values()) > 0
            and sum(per_closure["train_step"]["bsmm_dw"].values()) > 0,
            "the audited train step launched no dx or dw kernel")
    del rep
    gc.collect()
    torch.cuda.empty_cache()

    t2 = time.perf_counter()
    findings = {}
    for name in list_adaptable():
        on_card = lint_arch(name, device=device)
        on_cpu = lint_arch(name, device="cpu")
        got = sorted((f.code, f.where, f.severity) for f in on_card.findings)
        want = sorted((f.code, f.where, f.severity) for f in on_cpu.findings)
        require(got == want, f"lint {name}: the card's findings {got} != "
                f"the CPU's {want}")
        findings[name] = got
    t_c = time.perf_counter() - t2
    launches = lint_counts(B, FA, PA, TS)
    print(f"lint --all tiny on the card: findings per arch {findings} in "
          f"{t_c:.1f} s; lint path launches {launches}")
    summary = {"seconds": {"kernel_cases": t_a, "llama_full": t_b,
                           "all_tiny": t_c},
               "cases": cases, "llama_full_layers": LINT_LAYERS,
               "llama_full_per_closure": per_closure,
               "llama_full_hlo_findings": hlo,
               "findings_per_arch": findings}
    return launches, summary


# ---------------------------------------------------------------------------
# distribution: meshes, tensor- and data-parallel serving, grouped MoE
# dispatch, expert parallelism and the restart policy
# ---------------------------------------------------------------------------
DIST_LAYERS = 4             # legs (b) and (e): llama3.2-3b's 28 layers cut
DIST_REQUESTS = 8
DIST_MAX_NEW = 16
DIST_CAPACITY = 256
DIST_GROUPS = (1, 2, 4)     # leg (c)'s dispatch groups
DIST_MOE_TOKENS = (2, 64)   # leg (c)'s batch: 128 tokens
EP_EXPERTS, EP_SHAPE = 64, (5120, 8192)     # leg (d): llama4's MoE block
EP_TOKENS = 64
DIST_COUNTED = ("bsmm", "bsmm_epilogue", "bsmm_batched", "paged_attention",
                "flash_attention")


def dist_prompts(cfg):
    rng = np.random.default_rng(41)
    return [rng.integers(1, cfg.vocab_size, size=int(n))
            for n in rng.integers(5, 200, size=DIST_REQUESTS)]


def dist_serve(cfg, params, masks, mesh, device):
    """Serve the distribution legs' requests (8 x 16 tokens, 8 slots):
    ({uid: tokens}, {uid: (16, V) logits rows}, the engine)."""
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(params=params, cfg=cfg, batch_slots=DIST_REQUESTS,
                      capacity=DIST_CAPACITY, masks=masks, mesh=mesh,
                      device=device)
    nonfinite, rows = watch(eng, uids=range(DIST_REQUESTS))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=DIST_MAX_NEW)
            for i, p in enumerate(dist_prompts(cfg))]
    eng.tick_ms, _ = run_engine(eng, reqs, device)
    streams = {r.uid: list(r.tokens) for r in reqs}
    require(all(r.done for r in reqs) and nonfinite[0] == 0,
            "a distribution leg's request did not finish with finite logits")
    return streams, {u: np.stack(v) for u, v in rows.items()}, eng


def dist_counts(B, FA, PA) -> dict:
    """#1/#2/#1b/#6/#8 launches, #1/#2/#1b's routes and split launches,
    #8's routes."""
    return {**kernel_counts(B, FA, PA),
            "bsmm_routes": bsmm_routes(B, SERVE_ROUTED),
            "flash_by_route": dict(FA.flash_attention.launches_by_route)}


def dist_options(device="cuda", llama=None, ep=None, moe=None) -> dict:
    """The legs' sizes: llama3.2-3b at full width and depth (``llama``:
    another config), llama4's MoE block (``ep``: (experts, (d, f))) and
    deepseek-v3's serving experts (``moe``: (d, MoEConfig)); smaller
    ones rehearse the phase on the CPU."""
    from repro_torch.configs import get_arch
    if moe is None:
        ds = deepseek_config()
        moe = (ds.d_model, ds.moe)
    return {"device": device, "llama": llama or get_arch("llama3.2-3b"),
            "ep": ep or (EP_EXPERTS, EP_SHAPE), "moe": moe}


def dist_llama(opts, layers=None):
    """The options' llama (``layers`` deep, default all of them), seeded
    weights and a ~25 %-live seeded ticket."""
    import dataclasses

    from repro_torch.models import transformer as tfm
    device = opts["device"]
    cfg = opts["llama"]
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=min(layers, cfg.n_layers))
    params = tfm.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    return cfg, params, build_ticket(params, cfg, device)


TP_TRAIN_STEPS = 2          # leg (f): AdamW steps of the 4-layer llama
TP_TRAIN_BATCH, TP_TRAIN_SEQ = 4, 128
TP_TRAIN_LR = 1e-3
#: leg (f)'s bf16 tolerances against the meshless trainer on the same
#: rank.  Each step's loss within 1e-3 of it (relative).  Each step's
#: gradient, as the optimizer receives it (summed over the data axis,
#: gathered to full shape), within 3e-2 of the meshless leaf's norm
#: (||g - g0|| <= 3e-2 ||g0||: some 8 bf16 spacings, 2^-8, of
#: summation-order rounding through 4 layers).  The first update, w1 -
#: w0, within lr / 4 of the meshless one on every coordinate where that
#: one moved, both gradients share a sign, the meshless one is at least
#: the RMS of its leaf's nonzero entries and one bf16 spacing at |w0| is
#: at most lr / 8: there AdamW's first step moves a coordinate by lr
#: sign(g) (1 +- 2^-7 with m and v in bf16), so a skipped or misapplied
#: update is off by about lr, while the two runs' roundings are at most
#: a spacing apart.  Sign flips (a gradient near 0 either way) are
#: counted, not held: the gradient check bounds them
TP_LOSS_TOL = 1e-3
TP_GRAD_TOL = 3e-2
TP_UPDATE_TOL = 0.25
TP_TRAINED = ("bsmm", "bsmm_epilogue", "bsmm_dx", "bsmm_dw")


def train_batches(cfg, device, rows=TP_TRAIN_BATCH, seq=TP_TRAIN_SEQ):
    """The trainer legs' seeded batches (an encoder-decoder's with its
    frames in the model's dtype)."""
    from repro_torch.models.layers import _dtype
    gen = torch.Generator(device=device).manual_seed(31)
    out = []
    for _ in range(TP_TRAIN_STEPS):
        b = {k: torch.randint(0, cfg.vocab_size, (rows, seq), generator=gen,
                              device=device, dtype=torch.int32)
             for k in ("tokens", "labels")}
        if cfg.is_encoder_decoder:
            b["frames"] = torch.randn(
                rows, cfg.encoder_seq_len, cfg.d_model, generator=gen,
                device=device).to(_dtype(cfg.dtype))
        out.append(b)
    return out


class _Recorded:
    """A kernel wrapper that calls ``rec(*args)`` before it: attributes
    (the launch counters the wrapper updates through its module name)
    read and write the wrapper's own."""

    def __init__(self, fn, rec):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_rec", rec)

    def __call__(self, *args, **kw):
        self._rec(*args, **kw)
        return self._fn(*args, **kw)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


def _record_train_shapes(B, fn):
    """fn() with #1-#4's wrappers recording each launch's (M, K, N) (and
    #2's (bias, activation)), which ``dist_kernel_checks`` holds to the
    plain versions.  The launch counters move as without it."""
    seen = {n: set() for n in TP_TRAINED}
    seen["epilogues"] = set()

    def fwd(x2, w, plan):
        seen["bsmm"].add((x2.shape[0],) + tuple(w.shape))

    def epi(x2, w, plan, bias=None, act=None):
        seen["bsmm_epilogue"].add((x2.shape[0],) + tuple(w.shape))
        seen["epilogues"].add((None if bias is None else "bias", act))

    def dx(g, w, plan):
        seen["bsmm_dx"].add((g.shape[0],) + tuple(w.shape))

    def dw(x2, g, plan):
        seen["bsmm_dw"].add((x2.shape[0], x2.shape[1], g.shape[1]))

    orig = {n: getattr(B, n) for n in TP_TRAINED}
    for n, rec in zip(TP_TRAINED, (fwd, epi, dx, dw)):
        setattr(B, n, _Recorded(orig[n], rec))
    try:
        return fn(), seen
    finally:
        for n, f in orig.items():
            setattr(B, n, f)


def _mask_in_place(params, masks) -> None:
    """Every masked weight times its mask, in place (idempotent: no
    second tree)."""
    with torch.no_grad():
        for p, m in masked_leaves(params, masks):
            p.mul_(m)


def dist_train(cfg, params, masks, mesh, device, keep=None,
               store=True, draw=None, host=None) -> dict:
    """``TP_TRAIN_STEPS`` AdamW steps of ``cfg`` (masked by the ticket
    ``masks`` and through its plans where given; an encoder-decoder's
    on its frames; the weights masked in place), meshless (``mesh``
    None: ``make_train_step`` as the trainer builds it) or rank-local on
    ``mesh`` (``ShardedModel``, the
    local plans and masks, the tensor-parallel loss, scope and data-axis
    gradient sum).  Returns the losses; each step's gradients as the
    optimizer receives them and the parameters after each step, gathered
    to full shapes ({path: tensor}: the leaves ``keep(path)`` names, all
    by default; with ``store`` False gathered and dropped, where another
    rank keeps them; those ``host(path)`` names kept in host memory, and
    of their parameters only the first step's, which ``train_errors``
    reads); #1-#4's launches by route and the (M, K, N) of each.  ``draw()`` gives (params, masks) in place of the arguments:
    then the full tree is freed once a mesh run has cut its shards."""
    from repro_torch.core.masks import tree_flatten_with_path
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.distributed.sharding import gather_full
    from repro_torch.kernels import bsmm as B
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import Optimizer, adamw, constant, masked
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.plans import lm_train_plan

    if draw is not None:
        params, masks = draw()
    batches = train_batches(cfg, device)
    mod = encdec if cfg.is_encoder_decoder else tfm
    opt = adamw(constant(TP_TRAIN_LR))
    _mask_in_place(params, masks)
    if mesh is None:
        plan = lm_train_plan(masks)[0] if masks is not None else None
        opt = masked(opt, masks) if masks is not None else opt
        kw = {} if cfg.is_encoder_decoder else {"plan": plan}
        loss = lambda p, b: mod.loss_fn(p, cfg, b, **kw)  # noqa: E731
        model = shardings = None
    else:
        rules = tpar.mesh_rules(mesh, cfg)
        model = tpar.ShardedModel.from_full(params, cfg, rules, masks)
        plan = None
        if masks is not None:
            lmasks = tpar.localize(masks, model.shardings, contiguous=False)
            opt = masked(opt, lmasks)
            plan = lm_train_plan(lmasks)[0]
        loss = tpar.train_loss(model, plan=plan)
        params, shardings = model.params, model.shardings
        batches = [tpar.data_rows(b, rules) for b in batches]
    grads = []

    def update(g, state, p):            # what the optimizer receives
        grads.append(full(g))
        return opt.update(g, state, p)

    step = make_train_step(loss, Optimizer(opt.init, update), sharded=model)

    def full(tree, later=False):
        out = {}
        for path, leaf in tree_flatten_with_path(tree):
            if keep is not None and not keep(path):
                continue
            if later and host is not None and host(path):
                continue
            if shardings is not None:
                leaf = gather_full(leaf.contiguous(),
                                   tpar._lookup(shardings, path))
            if store:
                out[path] = (leaf.cpu() if host is not None and host(path)
                             else leaf)
        return out

    def run():
        state = opt.init(params)
        p, losses, after = params, [], []
        for b in batches:
            p, state, metrics = step(p, state, b)
            losses.append(float(metrics["loss"]))
            after.append(full(p, later=bool(after)))
        sync(device)
        return losses, after

    before = bsmm_routes(B)
    (losses, after), shapes = _record_train_shapes(B, run)
    out = {"losses": losses, "grads": grads, "params": after,
           "launches": routes_grown(before, bsmm_routes(B)),
           "shapes": shapes}
    if mesh is None:                    # w0, the same on every mesh
        out["before"] = full(params)
    return out


def routes_grown(before: dict, after: dict) -> dict:
    """``bsmm_routes``' growth between two readings."""
    return {n: {"launches_by_route": {
        r: k - before[n]["launches_by_route"][r]
        for r, k in v["launches_by_route"].items()},
        "split_launches": v["split_launches"] - before[n]["split_launches"]}
        for n, v in after.items()}


def _spacing(w: torch.Tensor) -> torch.Tensor:
    """One bf16 spacing at |w| (the subnormal spacing near 0)."""
    e = torch.frexp(w.float().abs().clamp_min(2.0 ** -126))[1]
    return torch.ldexp(torch.ones_like(w, dtype=torch.float32), e - 8)


def _zero_grad(path: str, norm: float, top: float) -> bool:
    """A leaf whose gradient is zero in exact arithmetic, left out of
    ``train_errors``, both runs' gradients there being rounding alone:
    an attention key bias (``bk``; the softmax cancels the q·b it adds to
    every key's score of a query), or any leaf whose meshless gradient
    norm is below 1e-9 of the largest leaf's (the sLSTM's stabilised
    input gate makes its bias's gradient ~1e-12)."""
    return path.rpartition("/")[2] == "bk" or norm < 1e-9 * top


def train_errors(got: dict, want: dict) -> dict:
    """Leg (f)'s checks of a mesh trainer (``got``) against the meshless
    one (``want``), both from ``dist_train``: the largest relative loss
    error; the largest per-leaf gradient error over the meshless leaf's
    norm (either step) and its leaf; the largest error of the first
    update over lr on the coordinates named at ``TP_UPDATE_TOL``, its
    leaf, and how many coordinates it covers.  A leaf kept in host
    memory is compared on the card."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    loss = max(abs(g - w) / abs(w) for g, w in zip(got["losses"],
                                                    want["losses"]))
    grad, grad_leaf = 0.0, None
    norms = [{path: float(w.to(dev).float().norm()) for path, w in ws.items()}
             for ws in want["grads"]]
    tops = [max(ns.values()) for ns in norms]
    for gs, ws, ns, top in zip(got["grads"], want["grads"], norms, tops):
        for path, w in ws.items():
            if _zero_grad(path, ns[path], top):
                continue
            w = w.to(dev).float()
            e = ((gs[path].to(dev).float() - w).norm()
                 / w.norm().clamp_min(1e-30)).item()
            if e > grad:
                grad, grad_leaf = e, path
    upd, upd_leaf, upd_g, covered, flips = 0.0, None, None, 0, 0
    lr = TP_TRAIN_LR
    for path, w0 in want["before"].items():
        if _zero_grad(path, norms[0][path], tops[0]):
            continue
        w0 = w0.to(dev)
        g0 = want["grads"][0][path].to(dev).float()
        g = got["grads"][0][path].to(dev).float()
        d_want = want["params"][0][path].to(dev).float() - w0.float()
        d_got = got["params"][0][path].to(dev).float() - w0.float()
        nz = g0[g0 != 0]
        if not nz.numel():
            continue
        large = ((d_want != 0) & (g0.abs() >= nz.square().mean().sqrt())
                 & (8 * _spacing(w0) <= lr))
        firm = large & (torch.sign(g) == torch.sign(g0))
        flips += int((large & ~firm).sum().item())
        n = int(firm.sum().item())
        if not n:
            continue
        covered += n
        err = torch.where(firm, (d_got - d_want).abs(), 0.0)
        i = int(err.argmax().item())
        e = err.flatten()[i].item() / lr
        if e > upd:
            upd, upd_leaf = e, path
            upd_g = (g0.flatten()[i].item(), g.flatten()[i].item(),
                     nz.abs().max().item())
    return {"loss_rel_err": loss, "grad_rel_err": grad,
            "grad_leaf": grad_leaf, "update_err_lr": upd,
            "update_leaf": upd_leaf, "update_grads": upd_g,
            "update_covered": covered, "sign_flips": flips}


def dist_one_rank(B, FA, PA, opts) -> dict:
    """Leg (a): a (1, 1) mesh over NCCL against the meshless engine on
    the same full-depth tree: streams and logits bitwise equal, every
    kernel's launches by route and split equal."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    device = opts["device"]
    cfg, params, masks = dist_llama(opts)
    runs, ticks = {}, {"meshless": [], "mesh_1x1": []}
    mesh = make_test_mesh(1, 1, device=device)
    try:
        # in turns (meshless, mesh, mesh, meshless) for the tick times;
        # each kind's first run is held bitwise and launch for launch
        for name in ("meshless", "mesh_1x1", "mesh_1x1", "meshless"):
            reset_kernel_counts(B, FA, PA)
            with torch.inference_mode():
                streams, rows, eng = dist_serve(
                    cfg, params, masks, mesh if name == "mesh_1x1" else None,
                    device)
            ticks[name].append(eng.tick_ms[len(eng.tick_ms) // 2])
            runs.setdefault(name, (streams, rows, dist_counts(B, FA, PA)))
            require(streams == runs[name][0], f"{name}: a repeated run's "
                    "streams differ")
            del eng
        del params, masks
        _free(device)
        # leg (f) on one rank: the (1, 1) NCCL mesh's trainer bitwise the
        # meshless trainer (losses, gradients, parameters), launch for
        # launch
        tcfg, tparams, tmasks = dist_llama(opts, DIST_LAYERS)
        t0 = dist_train(tcfg, tparams, tmasks, None, device)
        t1 = dist_train(tcfg, tparams, tmasks, mesh, device)
        del tparams, tmasks
    finally:
        dist.destroy_process_group()
    train_bitwise = t1["losses"] == t0["losses"] and all(
        torch.equal(got[k], v)
        for kind in ("grads", "params")
        for got, want in zip(t1[kind], t0[kind]) for k, v in want.items())
    print(f"distributed (f): 1x1 mesh trainer losses {t1['losses']} vs "
          f"meshless {t0['losses']}, bitwise {train_bitwise}, launches "
          f"{t1['launches']}")
    require(train_bitwise, "the 1x1 mesh trainer is not bitwise the "
            "meshless trainer")
    require(t1["launches"] == t0["launches"], "the 1x1 mesh trainer's "
            "launches differ from the meshless trainer's")
    require(all(sum(t1["launches"][n]["launches_by_route"].values()) > 0
                for n in BSMM_ROUTED), "the 1x1 mesh trainer missed a kernel")
    train_one = {"layers": tcfg.n_layers, "losses": t1["losses"],
                 "bitwise": train_bitwise, "launches": t1["launches"]}
    del t0, t1
    (s0, r0, c0), (s1, r1, c1) = runs["meshless"], runs["mesh_1x1"]
    tick = {f"{k}_ms_p50_by_run": v for k, v in ticks.items()}
    print(f"distributed (a): 1x1 mesh launches {c1}; decode ticks {tick}")
    require(s1 == s0, "the 1x1 mesh engine's streams differ from the "
            "meshless engine's")
    require(all(np.array_equal(r1[u], r0[u]) for u in r0),
            "the 1x1 mesh engine's logits are not bitwise the meshless "
            "engine's")
    require(c1 == c0, f"the 1x1 mesh engine's launches differ: {c1} vs {c0}")
    require(all(c1[n] > 0 for n in ("bsmm", "bsmm_epilogue",
                                    "paged_attention", "flash_attention")),
            "the 1x1 mesh engine missed a kernel")
    return {"layers": cfg.n_layers, "launches": c1, **tick,
            "streams_equal": True, "logits_bitwise": True,
            "train_1x1": train_one}


def dist_train_meshes(cfg, params, masks, meshes, device) -> dict:
    """Leg (f) on one rank: ``dist_train`` meshless, then on each
    (name, mesh) of ``meshes``, held to the meshless run by
    ``train_errors``; with every (M, K, N) that #1-#4 launched in any of
    the runs (``shapes``) and #2's (bias, activation) cases."""
    want = dist_train(cfg, params, masks, None, device)
    out = {"meshless_losses": want["losses"]}
    shapes = {k: set(v) for k, v in want["shapes"].items()}
    for name, mesh in meshes:
        t = time.perf_counter()
        got = dist_train(cfg, params, masks, mesh, device)
        out[name] = {"losses": got["losses"], **train_errors(got, want),
                     "launches": got["launches"],
                     "seconds": time.perf_counter() - t}
        for k, v in got["shapes"].items():
            shapes[k] |= v
        del got
    out["shapes"] = {k: sorted(v, key=str) for k, v in shapes.items()}
    return out


def check_train_leg(rank, name, tr, meshless_losses, kernels=True) -> None:
    """Print leg (f)'s (or (g)'s) reading of one rank's ``name`` mesh and
    require it within the stated tolerances, #1-#4 launched (where the
    model has ``kernels``: a planned projection)."""
    print(f"distributed (f) rank {rank} {name}: losses {tr['losses']} vs "
          f"meshless {meshless_losses} (rel err {tr['loss_rel_err']:.3e}, "
          f"tol {TP_LOSS_TOL}); gradients {tr['grad_rel_err']:.3e} of the "
          f"leaf's norm at {tr['grad_leaf']} (tol {TP_GRAD_TOL}); first "
          f"update {tr['update_err_lr']:.3e} lr at {tr['update_leaf']} "
          f"(g meshless, mesh, leaf max {tr['update_grads']}) over "
          f"{tr['update_covered']} coordinates, {tr['sign_flips']} sign "
          f"flips left out (tol {TP_UPDATE_TOL}); "
          f"launches {tr['launches']} in {tr['seconds']:.1f} s")
    require(tr["loss_rel_err"] <= TP_LOSS_TOL, f"{name}: the "
            "tensor-parallel trainer's losses are off the meshless "
            "trainer's")
    require(tr["grad_rel_err"] <= TP_GRAD_TOL, f"{name}: a gradient is "
            f"off the meshless trainer's ({tr['grad_leaf']})")
    require(tr["update_covered"] > 0, f"{name}: no coordinate to hold "
            "the first update to")
    require(tr["update_err_lr"] <= TP_UPDATE_TOL, f"{name}: the first "
            f"update is off the meshless trainer's ({tr['update_leaf']})")
    for n in TP_TRAINED if kernels else ():
        require(sum(tr["launches"][n]["launches_by_route"].values()) > 0,
                f"{name}: the trainer never launched {n}")


def _record_shapes(fn):
    """fn() with the block-sparse forward (#1/#2) and the attention
    kernels (#6, #8; #8 in the encoder too) recording each call's
    shapes: (rows, K, N) of #1/#2, (S, Hq, Hkv, hd, dv, causal) of #8
    and (Hq, Hkv, hd) of #6, which ``dist_kernel_checks`` holds to the
    plain versions."""
    from repro_torch.kernels import bsmm as B
    from repro_torch.models import attention, encdec
    seen = {"w": set(), "flash": set(), "paged": set(), "bsmm_calls": set(),
            "flash_calls": set(), "paged_calls": set()}
    orig = (B._forward, attention.flash_attention, attention.paged_attention)

    def fwd(x2, w, plan, bias, act):
        seen["w"].add(tuple(w.shape))
        seen["bsmm_calls"].add((x2.shape[0],) + tuple(w.shape))
        return orig[0](x2, w, plan, bias, act)

    def flash(q, k, v, **kw):
        seen["flash"].add((q.shape[-2], k.shape[-2]))
        seen["flash_calls"].add((q.shape[-3], q.shape[-2], k.shape[-2],
                                 q.shape[-1], v.shape[-1],
                                 bool(kw.get("causal", True))))
        return orig[1](q, k, v, **kw)

    def paged(q, kp, vp, *a, **kw):
        seen["paged"].add((q.shape[-2], kp.shape[-2]))
        seen["paged_calls"].add((q.shape[-2], kp.shape[-2], q.shape[-1]))
        return orig[2](q, kp, vp, *a, **kw)

    B._forward, attention.flash_attention, attention.paged_attention = \
        fwd, flash, paged
    encdec.flash_attention = flash          # the encoder's full attention
    try:
        return fn(), seen
    finally:
        B._forward, attention.flash_attention, attention.paged_attention = \
            orig
        encdec.flash_attention = orig[1]


def dist_rank(mesh12, ep_want, opts):
    """Legs (b) and (d) on one of two ranks sharing the card over gloo:
    llama3.2-3b at full width and 4 layers on (1, 2) and (2, 1) meshes
    against the meshless engine on this rank, and llama4's MoE block
    with this rank's 32 of 64 experts."""
    from repro_torch.kernels import bsmm as B
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.launch.mesh import make_test_mesh
    device = opts["device"]
    cfg, params, masks = dist_llama(opts, DIST_LAYERS)
    out = {"rank": mesh12.get_rank()}
    with torch.inference_mode():
        s0, r0, _ = dist_serve(cfg, params, masks, None, device)
        mesh21 = make_test_mesh(2, 1, device=device, backend="gloo")
        for name, mesh in (("1x2", mesh12), ("2x1", mesh21)):
            reset_kernel_counts(B, FA, PA)
            (streams, rows, eng), seen = _record_shapes(
                lambda: dist_serve(cfg, params, masks, mesh, device))
            counts = dist_counts(B, FA, PA)
            err, diverged = 0.0, 0
            for u, want in r0.items():
                got = rows[u]
                n = len(want)
                first = next((i for i in range(n)
                              if streams[u][i] != s0[u][i]), None)
                if first is not None:
                    diverged += 1
                    n = first + 1            # rows up to the divergence
                err = max(err, rel_row_err(list(got[:n]),
                                           torch.as_tensor(want[:n])))
            gen = eng.generations[-1]
            out[name] = {
                "launches": counts, "rel_row_err": err,
                "tick_ms_p50": eng.tick_ms[len(eng.tick_ms) // 2],
                "greedy_divergences": diverged,
                "local_cfg": (gen.cfg.n_heads, gen.cfg.n_kv_heads),
                "kept_whole": eng.kept_whole,
                "weights": sorted(seen["w"]), "flash_heads":
                sorted(seen["flash"]), "paged_heads": sorted(seen["paged"]),
                **{k: sorted(seen[k]) for k in ("bsmm_calls", "flash_calls",
                                                "paged_calls")}}
            del eng, rows
    # leg (f): the tensor-parallel trainer on both meshes against the
    # meshless trainer on this rank
    out["train"] = dist_train_meshes(cfg, params, masks,
                                     (("1x2", mesh12), ("2x1", mesh21)),
                                     device)
    del params, masks
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    with torch.inference_mode():
        out["ep"] = ep_rank(mesh12, ep_want, opts)
    return out


def ep_block(opts, experts, seed=77):
    """llama4-maverick's MoE block (5120 <-> 8192, top-1) for
    ``experts`` (a range of its 64): per-expert seeded weights, so any
    range is a shard of the same block, under one ~25 %-live ticket
    shared by the experts, the router and the input."""
    from repro_torch.kernels.bsmm import make_tile_plan
    device = opts["device"]
    E, (d, f) = opts["ep"]
    rng = np.random.default_rng(seed)
    plans, masks = {}, {}
    for key, (K, N) in (("up", (d, f)), ("gate", (d, f)), ("down", (f, d))):
        bm = random_bitmap(rng, K, N)
        plans[key] = make_tile_plan(np.kron(bm, np.ones((128, 128), bool)))
        masks[key] = torch.as_tensor(bm, device=device) \
            .repeat_interleave(128, 0).repeat_interleave(128, 1) \
            .to(torch.bfloat16)
    p = {}
    for j, (key, (K, N)) in enumerate((("up", (d, f)), ("gate", (d, f)),
                                       ("down", (f, d)))):
        ws = []
        for e in experts:
            g = torch.Generator(device=device).manual_seed(
                seed + 3 * (e + 1) + j)
            ws.append(torch.randn(K, N, device=device, generator=g,
                                  dtype=torch.bfloat16) / K ** 0.5
                      * masks[key])
        p[key] = torch.stack(ws)
    g = torch.Generator(device=device).manual_seed(seed)
    p["router"] = torch.randn(d, E, device=device, generator=g,
                              dtype=torch.bfloat16) / d ** 0.5
    x = torch.randn(1, EP_TOKENS, d, device=device, generator=g,
                    dtype=torch.bfloat16)
    return p, plans, x


def ep_moe_cfg(opts):
    from repro_torch.configs import MoEConfig
    E, (_, f) = opts["ep"]
    return MoEConfig(num_experts=E, top_k=1, d_ff_expert=f)


def ep_rank(mesh, want, opts):
    """Leg (d) on one rank: its 32 experts through #1b, the outputs
    gathered over the model axis, held to the one-rank block."""
    from repro_torch.distributed.tensor_parallel import (TensorParallel,
                                                         scope)
    from repro_torch.kernels import bsmm as B
    from repro_torch.models.moe import moe_forward
    r = mesh.get_local_rank("model")
    half = opts["ep"][0] // 2
    p, plans, x = ep_block(opts, range(r * half, (r + 1) * half))
    tp = TensorParallel(mesh, [p["up"], p["gate"], p["down"]])
    reset_bsmm_routes(B, ("bsmm_batched",))
    with scope(None, tp):
        y = moe_forward(p, x, ep_moe_cfg(opts), "silu", True, plan=plans).y
    sync(opts["device"])
    want = want.to(y.device)
    return {"experts": half, "launches": B.bsmm_batched.launches,
            "max_abs_err": (y.float() - want.float()).abs().max().item(),
            "tol": tolerance(torch.bfloat16, want),
            "local_up": tuple(p["up"].shape)}


def dist_grouped_moe(B, opts) -> dict:
    """Leg (c): grouped dispatch at deepseek-v3's expert widths (7168 <->
    2048, top-8) over its 256 routed experts, G = 1, 2, 4: one #1b
    launch per projection, held to the same dispatch through #1b's plain
    version, and ``drop_fraction`` as the capacity formula predicts."""
    import repro_torch.models.moe as moe_mod
    from repro_torch.kernels.bsmm import make_tile_plan
    device = opts["device"]
    d, moe = opts["moe"]
    f, E = moe.d_ff_expert, moe.num_experts
    rng = np.random.default_rng(53)
    g = torch.Generator(device=device).manual_seed(53)
    p, plans = {}, {}
    for key, (K, N) in (("up", (d, f)), ("gate", (d, f)), ("down", (f, d))):
        bm = random_bitmap(rng, K, N)
        plans[key] = make_tile_plan(np.kron(bm, np.ones((128, 128), bool)))
        p[key] = torch.randn(E, K, N, device=device, generator=g,
                             dtype=torch.bfloat16) / K ** 0.5
    p["router"] = torch.randn(d, E, device=device, generator=g,
                              dtype=torch.bfloat16) / d ** 0.5
    x = torch.randn(*DIST_MOE_TOKENS, d, device=device, generator=g,
                    dtype=torch.bfloat16)
    T = x.shape[0] * x.shape[1]
    out = {"experts": E, "tokens": T, "groups": {}}
    plain_apply = moe_mod.bsmm_batched_apply
    for G in DIST_GROUPS:
        reset_bsmm_routes(B, ("bsmm_batched",))
        with torch.inference_mode():
            got = moe_mod.moe_forward(p, x, moe, "silu", True,
                                      num_groups=G, plan=plans)
            sync(device)
            launches = B.bsmm_batched.launches
            routes = bsmm_routes(B, ("bsmm_batched",))["bsmm_batched"]
            moe_mod.bsmm_batched_apply = \
                lambda a, w, plan: B.bsmm_batched_plain(a, w, plan)
            try:
                want = moe_mod.moe_forward(p, x, moe, "silu", True,
                                           num_groups=G, plan=plans)
            finally:
                moe_mod.bsmm_batched_apply = plain_apply
            # the capacity formula: pairs past C per (group, expert)
            Tg = T // G
            C = moe_mod.expert_capacity(Tg, moe)
            logits = (x.reshape(G, Tg, d) @ p["router"]).float()
            top_e = torch.sort(torch.softmax(logits, -1), dim=-1,
                               descending=True,
                               stable=True)[1][..., :moe.top_k]
            per = torch.stack([torch.bincount(top_e[i].reshape(-1),
                                              minlength=E) for i in range(G)])
            drop = (per - C).clamp_min(0).sum().item() / (T * moe.top_k)
        err = (got.y.float() - want.y.float()).abs().max().item()
        tol = tolerance(torch.bfloat16, want.y)
        print(f"distributed (c): G={G} C={C} #1b launches {launches} "
              f"{routes} max_abs_err {err:.3e} (tol {tol:.3e}) "
              f"drop {float(got.drop_fraction):.6f} (formula {drop:.6f})")
        require(launches == 3, f"grouped MoE G={G}: {launches} #1b "
                "launches, want one per projection")
        require(err <= tol, f"grouped MoE G={G} disagrees with its plain "
                "version")
        require(abs(float(got.drop_fraction) - drop) < 1e-6,
                f"grouped MoE G={G}: drop_fraction off the formula")
        out["groups"][G] = {"capacity": C, "launches": launches,
                            "routes": routes, "max_abs_err": err,
                            "tol": tol,
                            "drop_fraction": float(got.drop_fraction)}
    return out


def dist_restart(opts) -> dict:
    """Leg (e): ``Supervisor`` around a 2-layer full-width llama3.2-3b
    retrain (``make_trainer``, a blocking checkpoint every 2 steps)
    whose third step fails once: it resumes from step 2's checkpoint and
    reaches its 4 steps."""
    import dataclasses
    import tempfile

    from repro_torch._bridge import tree_leaves
    from repro_torch.api import make_adapter
    from repro_torch.configs import get_arch
    from repro_torch.distributed.fault_tolerance import Supervisor
    device = opts["device"]
    adapter = make_adapter(
        dataclasses.replace(opts["llama"], n_layers=2),
        scale="full", batch_size=8, seq_len=128, device=device)
    params = adapter.init_params(torch.Generator(device=device).manual_seed(0))
    masks = build_planned_ticket(params, device)
    failed, starts = [False], []
    with tempfile.TemporaryDirectory() as ckpt:
        def make():
            tr = adapter.make_trainer(params, masks, ckpt_dir=ckpt,
                                      learning_rate=1e-4)
            tr.ckpt_every = 2               # committed before step 3 runs
            tr.ckpt.async_save = False
            starts.append(tr.state.step)
            inner = tr.step_fn

            def step_fn(*a):
                if tr.state.step == 2 and not failed[0]:
                    failed[0] = True
                    raise RuntimeError("injected failure in step 3")
                return inner(*a)
            tr.step_fn = step_fn
            return tr

        sup = Supervisor(make, max_restarts=2)
        tr = sup.run(4)
    require(failed[0] and sup.restarts == 1 and tr.state.step == 4,
            f"restart leg: step {tr.state.step}, restarts {sup.restarts}")
    require(starts == [0, 2],
            f"restart leg did not resume from its checkpoint: {starts}")
    require(all(bool(torch.isfinite(t).all())
                for t in tree_leaves(tr.state.params)),
            "restart leg: non-finite parameters")
    print(f"distributed (e): restarts {sup.restarts}, trainer starts at "
          f"steps {starts}, final step {tr.state.step}")
    return {"restarts": sup.restarts, "starts": starts,
            "final_step": tr.state.step}


def dist_kernel_checks(B, FA, PA, ranks) -> dict:
    """#1-#4, #8 and #6 held to their plain versions (bf16 and f32, the
    checks' usual tolerances, routes and splits) at every shape legs (b)
    and (f) launched them at on either rank: each (K, N) of #1/#2 at the
    rows it saw (decode 8 on (1, 2) and 4 on (2, 1), the prompts'
    buckets, the trainer's 512 and 256) with every (bias, activation)
    case the trainer ran, each (K, N) of #3/#4 at the trainer's rows, #8
    at each (S, heads) and #6 at each head count; timed at 8 decode rows
    (#1/#2) and at every #8/#6 shape.  Run after the legs, so none of
    these launches is counted as theirs."""
    legs = [r[name] for r in ranks for name in ("1x2", "2x1")]
    trained = [r["train"]["shapes"] for r in ranks]
    return kernel_checks_at(
        B, FA, PA,
        [c for leg in legs for c in leg["bsmm_calls"]] + [
            c for sh in trained for n in ("bsmm", "bsmm_epilogue")
            for c in sh[n]],
        tuple(c for sh in trained for c in sh["epilogues"]),
        [c for sh in trained for n in ("bsmm_dx", "bsmm_dw")
         for c in sh[n]],
        sorted({c for leg in legs for c in leg["flash_calls"]}),
        [c for leg in legs for c in leg["paged_calls"]])


def kernel_checks_at(B, FA, PA, fwd, epilogues, grads, flash, paged) -> dict:
    """#1/#2 at each (K, N) of ``fwd``'s (M, K, N) at the rows it saw,
    with (None, silu) and each (bias, activation) of ``epilogues``;
    #3/#4 at each (K, N) of ``grads``' at its rows; #8 at each (S, Hq,
    Hkv, hd, dv, causal) of ``flash`` (bf16); #6 at each (Hq, Hkv, hd) of
    ``paged``; timed at 8 rows (#1/#2) and at every #8/#6 shape."""
    by_w: dict = {}
    for M, K, N in fwd:
        by_w.setdefault((K, N), set()).add(M)
    epilogues = tuple(sorted({(None, "silu")} | {
        tuple(c) for c in epilogues}, key=str))
    by_g: dict = {}
    for M, K, N in grads:
        by_g.setdefault((K, N), set()).add(M)
    err = {"bsmm": 0.0, "bsmm_epilogue": 0.0}
    grad_err = {"bsmm_dx": 0.0, "bsmm_dw": 0.0}
    times = []
    with torch.inference_mode():
        for i, ((K, N), rows) in enumerate(sorted(by_w.items())):
            e, t = check_bsmm(B, ((K, N),), tuple(sorted(rows)), epilogues,
                              seed=60 + i)
            err = {k: max(v, e[k]) for k, v in err.items()}
            times += [r for r in t if r["M"] == 8]
    # the trainers' backward shapes (outside inference mode, as trained)
    for i, ((K, N), rows) in enumerate(sorted(by_g.items())):
        e, _ = check_bsmm_grads(B, ((K, N),), timed=False, seed=80 + i,
                                rows=tuple(sorted(rows)))
        grad_err = {k: max(v, e[k]) for k, v in grad_err.items()}
    with torch.inference_mode():
        flash_err, flash_rows = check_flash(
            FA, tuple(tuple(c) + (torch.bfloat16,) for c in flash))
        paged_err, paged_rows = 0.0, []
        for j, (hq, hkv, hd) in enumerate(sorted({tuple(c) for c in paged})):
            e, row = check_paged(PA, Hq=hq, Hkv=hkv, hd=hd, seed=70 + j)
            paged_err = max(paged_err, e)
            paged_rows.append({"Hq": hq, "Hkv": hkv, "hd": hd,
                               "max_abs_err": e, **row})
    print(f"kernel checks at a leg's shapes: #1/#2 at {len(by_w)} weight "
          f"shapes {sorted(by_w.items())} with {epilogues}, #3/#4 at "
          f"{sorted(by_g.items())}, #8 at {flash}, #6 at "
          f"{[(r['Hq'], r['Hkv']) for r in paged_rows]}: max_abs_err {err}, "
          f"{grad_err}, #8 {flash_err:.3e}, #6 {paged_err:.3e}")
    return {"bsmm_err": err, "bsmm_times": times,
            "bsmm_rows": {f"{K}x{N}": sorted(m) for (K, N), m in by_w.items()},
            "grad_err": grad_err,
            "grad_rows": {f"{K}x{N}": sorted(m) for (K, N), m in by_g.items()},
            "flash_err": flash_err, "flash": flash_rows,
            "paged_err": paged_err, "paged": paged_rows}


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def distributed_phase(B, FA, PA, opts=None) -> tuple:
    """Legs (a)-(e) (see the module docstring) at ``opts``'s sizes
    (``dist_options``); returns (launches by kernel and leg, summary)."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.moe import moe_forward
    opts = opts or dist_options()
    device = opts["device"]
    summary = {"one_rank": dist_one_rank(B, FA, PA, opts)}
    _free(device)
    # leg (d)'s one-rank block, freed before the two ranks start
    p, plans, x = ep_block(opts, range(opts["ep"][0]))
    with torch.inference_mode():
        y_one = moe_forward(p, x, ep_moe_cfg(opts), "silu", True,
                            plan=plans).y.cpu()
    del p, plans, x
    _free(device)
    ranks = run_ranks(dist_rank, 1, 2, device=device, backend="gloo",
                      args=(y_one, opts), timeout_s=600)
    c = opts["llama"]
    hq, hkv, hd, d, ff = (c.n_heads, c.n_kv_heads, c.head_dim_, c.d_model,
                          c.d_ff)
    for res in ranks:
        for name, want_heads in (("1x2", (hq // 2, hkv // 2)),
                                 ("2x1", (hq, hkv))):
            leg = res[name]
            print(f"distributed (b) rank {res['rank']} {name}: "
                  f"heads {leg['local_cfg']} weights {leg['weights']} "
                  f"flash {leg['flash_heads']} paged {leg['paged_heads']} "
                  f"rel_row_err {leg['rel_row_err']:.3e} divergences "
                  f"{leg['greedy_divergences']} launches {leg['launches']}")
            require(leg["local_cfg"] == want_heads and not leg["kept_whole"],
                    f"{name}: the rank's attention is not at its local heads")
            require(leg["rel_row_err"] <= TEACHER_TOL,
                    f"{name}: logits off the single-rank engine's")
            require(set(leg["flash_heads"]) == {want_heads}
                    and set(leg["paged_heads"]) == {want_heads},
                    f"{name}: #8/#6 not at the local heads")
            for n in ("bsmm", "bsmm_epilogue", "paged_attention",
                      "flash_attention"):
                require(leg["launches"][n] > 0, f"{name}: {n} not launched")
        # wq 1536, wk/wv 512, up/gate 4096 columns; wo 1536 and down
        # 4096 rows: every projection on the rank's local plan
        q, kv, f = hq * hd // 2, hkv * hd // 2, ff // 2
        require(set(map(tuple, res["1x2"]["weights"])) == {
            (d, q), (d, kv), (q, d), (d, f), (f, d)},
            "1x2: a projection ran off its local shape")
        for name in ("1x2", "2x1"):
            check_train_leg(res["rank"], name, res["train"][name],
                            res["train"]["meshless_losses"])
        ep = res["ep"]
        print(f"distributed (d) rank {res['rank']}: {ep}")
        require(ep["max_abs_err"] <= ep["tol"], f"expert-parallel rank "
                f"{res['rank']} disagrees with the one-rank block")
        require(ep["launches"] == 3, f"expert-parallel rank {res['rank']}: "
                f"{ep['launches']} #1b launches, want one per projection")
    summary["ranks"] = ranks
    _free(device)
    summary["kernel_checks"] = dist_kernel_checks(B, FA, PA, ranks)
    _free(device)
    summary["grouped_moe"] = dist_grouped_moe(B, opts)
    _free(device)
    summary["restart"] = dist_restart(opts)
    launches = {n: {"one_rank": summary["one_rank"]["launches"][n],
                    "ranks_1x2": [r["1x2"]["launches"][n] for r in ranks],
                    "ranks_2x1": [r["2x1"]["launches"][n] for r in ranks]}
                for n in DIST_COUNTED}
    launches["bsmm_batched"]["ep_1x2"] = [r["ep"]["launches"] for r in ranks]
    launches["bsmm_batched"]["grouped_moe"] = {
        G: v["launches"] for G, v in summary["grouped_moe"]["groups"].items()}
    return launches, summary


# ---------------------------------------------------------------------------
# 6g. distribution, leg (g): the last families on a mesh
# ---------------------------------------------------------------------------
FAM_MAX_NEW = 8
#: each family's prompts (recurrentgemma-2b: one past its 2048 window, a
#: multiple of it, as the windowed prefill's two-chunk form takes it)
FAM_LENGTHS = {"recurrentgemma-2b": (5, 130, 300, 4096),
               "xlstm-125m": (5, 17, 64, 129),
               "deepseek-v3-671b": (5, 17, 64, 129),
               "whisper-tiny": (4, 9, 17, 24)}
FAM_CAPACITY = {"recurrentgemma-2b": HYBRID_CAPACITY,
                "whisper-tiny": WHISPER_CAPACITY}
FAM_RG_TRAIN_LAYERS = 4     # recurrentgemma-2b's retrain: (R, R, A) + R
#: deepseek-v3's retrain: one MoE layer (``first_moe_layer`` 0) of 16
#: routed experts (top-8) and 32768 vocabulary rows (two f32 trainers of
#: its 129280-row tables do not fit the shared card)
FAM_DS_TRAIN = (1, 16, 32768)
#: llama4-maverick's (2, 1) retrain: layers, routed experts and the
#: vocabulary's rows (each data rank trains the whole model; two trainers
#: of its 202048-row tables alone, 2.1 G parameters, would not fit the
#: shared card)
FAM_L4_TRAIN = (2, 4, 32768)
FAM_DS_PREFILL = 300        # rank 0's dense prefill, traced by ``dryrun``
#: the kernels of leg (g)'s path (``routes_now`` names; paged_attention:
#: the fused-V form, #7)
FAM_PATH = ("bsmm", "bsmm_epilogue", "bsmm_dx", "bsmm_dw", "bsmm_batched",
            "bsmm_batched_dx", "bsmm_batched_dw", "flash_attention",
            "paged_attention")
FAM_BATCHED = ("bsmm_batched", "bsmm_batched_dx", "bsmm_batched_dw")


def fam_options(device="cuda", configs=None) -> dict:
    """Leg (g)'s models: recurrentgemma-2b (26 layers), xlstm-125m (in
    float32) and whisper-tiny as published, deepseek-v3 at 4 layers and
    256 experts
    (``deepseek_config``), their retrain cuts and llama4-maverick's (2,
    1) retrain cut; ``configs`` replaces any by key (smaller ones
    rehearse the leg on the CPU)."""
    from repro_torch.configs import get_arch
    ds, l4 = get_arch("deepseek-v3-671b"), get_arch(
        "llama4-maverick-400b-a17b")
    rg = get_arch("recurrentgemma-2b")
    out = {"device": device, "rg": rg,
           # the trainers in float32 (whisper's in bf16): their bf16
           # gradients differ from the meshless trainer's by the rounding
           # of partial sums that cancel, 5.8e-2-1.3e-1 of a leaf's norm
           # (a router whose top-8 of 8 renormalise, top-1 flips), past
           # ``TP_GRAD_TOL``; recurrentgemma's also trains in bf16, held
           # to float32 by ``fam_bf16_witness`` (PERF.md §6)
           "rg_train": dataclasses.replace(rg, n_layers=FAM_RG_TRAIN_LAYERS,
                                           dtype="float32"),
           # float32: the random-weight xLSTM grows a rounding difference
           # some 100-fold over its 12 layers (bf16: a block's 5e-3 becomes
           # 0.27 of the logits), so a bf16 mesh engine cannot be held to
           # the meshless one; in float32 it stays near 3e-5
           "xl": dataclasses.replace(get_arch("xlstm-125m"),
                                     dtype="float32"),
           "ds": deepseek_config(),
           "ds_train": dataclasses.replace(
               ds, n_layers=FAM_DS_TRAIN[0], vocab_size=FAM_DS_TRAIN[2],
               dtype="float32", moe=dataclasses.replace(
                   ds.moe, num_experts=FAM_DS_TRAIN[1], first_moe_layer=0)),
           "wh": get_arch("whisper-tiny"),
           "l4_train": dataclasses.replace(
               l4, n_layers=FAM_L4_TRAIN[0], vocab_size=FAM_L4_TRAIN[2],
               dtype="float32", moe=dataclasses.replace(
                   l4.moe, num_experts=FAM_L4_TRAIN[1]))}
    out.update(configs or {})
    return out


def fam_draw(cfg, device):
    """Seed-0 parameters of ``cfg`` on ``device`` (every rank draws the
    same tree)."""
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tfm
    mod = encdec if cfg.is_encoder_decoder else tfm
    return mod.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg, device=device)


def fam_engine(cfg, params, masks, mesh, device):
    from repro_torch.models import encdec
    from repro_torch.serve.engine import ServeEngine
    kw = (dict(prefill_fn=encdec.prefill, decode_fn=encdec.decode_step)
          if cfg.is_encoder_decoder else {})
    lengths = FAM_LENGTHS.get(cfg.name, (5, 17, 64, 129))
    return ServeEngine(params=params, cfg=cfg, batch_slots=len(lengths),
                       capacity=FAM_CAPACITY.get(cfg.name, 512), masks=masks,
                       mesh=mesh, device=device, **kw)


def fam_serve(eng, cfg, device):
    """Serve the family's prompts (seeded; an encoder-decoder's with
    seeded frames) on ``eng``, ``FAM_MAX_NEW`` tokens each: ({uid:
    tokens}, {uid: logits rows}); every request done, every logit
    finite."""
    from repro_torch.serve.engine import Request
    lengths = FAM_LENGTHS.get(cfg.name, (5, 17, 64, 129))
    rng = np.random.default_rng(43)
    reqs = []
    for i, n in enumerate(lengths):
        frames = (rng.standard_normal((cfg.encoder_seq_len, cfg.d_model))
                  .astype(np.float32) if cfg.is_encoder_decoder else None)
        reqs.append(Request(uid=i, prompt=rng.integers(1, cfg.vocab_size,
                                                       size=int(n)),
                            max_new_tokens=FAM_MAX_NEW, frames=frames))
    nonfinite, rows = watch(eng, uids=range(len(reqs)))
    eng.tick_ms, _ = run_engine(eng, reqs, device)
    require(all(r.done for r in reqs) and nonfinite[0] == 0,
            f"leg (g) {cfg.name}: a request did not finish with finite "
            "logits")
    return ({r.uid: list(r.tokens) for r in reqs},
            {u: np.stack(v) for u, v in rows.items()})


def fam_compare(streams, rows, s0, r0) -> tuple:
    """(the largest logits-row error against the meshless engine's,
    relative to each row's max |logit|, over the rows up to each
    stream's first divergence; the greedy divergences)."""
    err, diverged = 0.0, 0
    for u, want in r0.items():
        n = len(want)
        first = next((i for i in range(n) if streams[u][i] != s0[u][i]),
                     None)
        if first is not None:
            diverged += 1
            n = first + 1
        err = max(err, rel_row_err(list(rows[u][:n]),
                                   torch.as_tensor(want[:n])))
    return err, diverged


def fam_serve_meshes(B, FA, PA, TS, cfg, params, masks, meshes, device,
                     want=None, build=None, after=None) -> dict:
    """The family's engine on each (name, mesh) of ``meshes`` against
    the meshless engine's streams and rows (``want``, else this rank's
    own meshless engine on ``params``): each mesh's row error and
    divergences, local heads, kept-whole leaves, launches by route and
    the kernels' entry shapes.  ``build(mesh)`` makes a mesh engine in
    place of ``fam_engine`` on ``params``; ``after(engine)``'s reading
    is kept too."""
    out = {}
    if want is None:
        with torch.inference_mode():
            want = fam_serve(fam_engine(cfg, params, masks, None, device),
                             cfg, device)
        _free(device)
    s0, r0 = want
    for name, mesh in meshes:
        eng = (build(mesh) if build is not None
               else fam_engine(cfg, params, masks, mesh, device))
        before = routes_now(B, FA, PA, TS)
        with torch.inference_mode():
            (streams, rows), seen = _record_shapes(
                lambda: fam_serve(eng, cfg, device))
        err, diverged = fam_compare(streams, rows, s0, r0)
        gen = eng.generations[-1]
        out[name] = {
            "rel_row_err": err, "greedy_divergences": diverged,
            "tick_ms_p50": eng.tick_ms[len(eng.tick_ms) // 2],
            "local_cfg": (gen.cfg.n_heads, gen.cfg.n_kv_heads),
            "kept_whole": sorted(p for p, _ in eng.kept_whole),
            "launches": routes_since(before, routes_now(B, FA, PA, TS)),
            **{k: sorted(seen[k]) for k in ("bsmm_calls", "flash_calls",
                                            "paged_calls")}}
        if after is not None:
            out[name]["after"] = after(eng)
        del eng, rows
        _free(device)
    return out


def fam_train(cfg, draw, meshes, device, rank, keep=None, host=None,
              groups=1, witness=None) -> dict:
    """``dist_train`` of ``cfg`` (each run on ``draw()``'s (params,
    ticket), drawn anew: the other rank holds nothing meanwhile) meshless
    on rank 0 (the other rank waits; an MoE model at ``groups`` dispatch
    groups, one a data rank of the meshes) and on each (name, mesh),
    held to it on rank 0 by ``train_errors`` (the leaves ``keep`` names,
    those ``host`` names kept in host memory); ``witness`` (a bf16
    config and its draw) adds ``fam_bf16_witness`` on the first mesh as
    "bf16"; the (M, K, N) of every #1-#4 launch."""
    import torch.distributed as dist

    from repro_torch.models import hooks
    want = None
    if rank == 0:
        prev = hooks.moe_groups()
        hooks.set_moe_groups(groups)
        try:
            want = dist_train(cfg, None, None, None, device, keep=keep,
                              draw=draw, host=host)
        finally:
            hooks.set_moe_groups(prev)
        _free(device)
    dist.barrier()
    out = {"meshless_losses": want["losses"] if want else None}
    shapes = {k: set(v) for k, v in want["shapes"].items()} if want else {}
    for name, mesh in meshes:
        t = time.perf_counter()
        got = dist_train(cfg, None, None, mesh, device, keep=keep,
                         store=rank == 0, draw=draw, host=host)
        if rank == 0:
            out[name] = {"losses": got["losses"], **train_errors(got, want),
                         "launches": got["launches"],
                         "seconds": time.perf_counter() - t}
        for k, v in got["shapes"].items():
            shapes.setdefault(k, set()).update(v)
        del got
        _free(device)
    if witness is not None:
        out["bf16"] = fam_bf16_witness(*witness, meshes[0][1], device, rank,
                                       keep, want, shapes)
    out["shapes"] = {k: sorted(v, key=str) for k, v in shapes.items()}
    return out


#: leg (g)'s bf16 mesh trainer: each leaf's gradient (over its float32
#: norm) within twice the meshless bf16 trainer's own distance from the
#: float32 meshless trainer, or ``TP_GRAD_TOL`` where that is larger.
#: Both bf16 trainers round alike (their weights rounded from the same
#: float32 tree, their sums in bf16), so a fault on the mesh path shows
#: as the mesh trainer alone leaving float32 (a dropped all-reduce moved
#: leg (f)'s leaves by 0.94-0.96 of their norm)
FAM_BF16_RATIO = 2.0


def fam_bf16_witness(cfg, draw, mesh, device, rank, keep, exact,
                     shapes) -> dict:
    """A bf16 ``cfg`` trained meshless on rank 0 and on ``mesh`` (both on
    ``draw()``: the float32 run's tree cast), held on rank 0 to the
    meshless bf16 trainer by ``train_errors`` (losses, first update) and
    to ``exact``, the float32 meshless run, leaf by leaf as
    ``FAM_BF16_RATIO`` says; adds the runs' #1-#4 shapes to ``shapes``.
    Returns the reading (None on the other rank)."""
    import torch.distributed as dist
    plain = None
    if rank == 0:
        plain = dist_train(cfg, None, None, None, device, keep=keep,
                           draw=draw)
        _free(device)
    dist.barrier()
    t = time.perf_counter()
    got = dist_train(cfg, None, None, mesh, device, keep=keep,
                     store=rank == 0, draw=draw)
    for run in (plain, got) if plain else (got,):
        for k, v in run["shapes"].items():
            shapes.setdefault(k, set()).update(v)
    if rank != 0:
        return None
    out = {"losses": got["losses"], "meshless_losses": plain["losses"],
           **train_errors(got, plain), "launches": got["launches"],
           "seconds": time.perf_counter() - t}
    leaves = {}
    for gm, gp, ge in zip(got["grads"], plain["grads"], exact["grads"]):
        norms = {p: float(w.float().norm()) for p, w in ge.items()}
        top = max(norms.values())
        for path, w in ge.items():
            if _zero_grad(path, norms[path], top):
                continue
            w = w.float()
            mesh_d, plain_d = (float((g[path].float() - w).norm())
                               / norms[path] for g in (gm, gp))
            gate = max(TP_GRAD_TOL, FAM_BF16_RATIO * plain_d)
            if mesh_d / gate > leaves.get(path, (0.0,))[0]:
                leaves[path] = (mesh_d / gate, mesh_d, plain_d)
    worst = sorted(leaves.items(), key=lambda kv: -kv[1][1])[:6]
    out["bf16_slack"] = max(v[0] for v in leaves.values())
    out["bf16_leaves"] = {p: {"slack": v[0], "mesh_to_f32": v[1],
                              "meshless_to_f32": v[2]} for p, v in worst}
    del got, plain
    _free(device)
    return out


def _held(path: str) -> bool:
    """The leaves a big model's trainer check compares: all but the
    vocabulary's tables (leg (f) holds the vocab-parallel path)."""
    return not path.endswith("/table")


def _experts(path: str) -> bool:
    """An MoE model's routed experts: their gathered copies are kept in
    host memory (they would not fit beside the trainers on the card)."""
    return any(path.endswith(f"/moe/{w}") for w in ("up", "gate", "down"))


def _record_batched(B, fn):
    """fn() with #1b/#3b/#4b recording each launch's (E, M, K, N, dtype
    name)."""
    seen = {n: set() for n in FAM_BATCHED}

    def name(t):
        return str(t.dtype).removeprefix("torch.")

    def fwd(a, w, plan):
        seen["bsmm_batched"].add(tuple(a.shape) + (w.shape[-1], name(a)))

    def dx(g, w, plan):
        seen["bsmm_batched_dx"].add(tuple(g.shape[:2]) + tuple(w.shape[-2:])
                                    + (name(g),))

    def dw(x, g, plan):
        seen["bsmm_batched_dw"].add(tuple(x.shape) + (g.shape[-1], name(x)))

    orig = {n: getattr(B, n) for n in FAM_BATCHED}
    for n, rec in zip(FAM_BATCHED, (fwd, dx, dw)):
        setattr(B, n, _Recorded(orig[n], rec))
    try:
        return fn(), seen
    finally:
        for n, f in orig.items():
            setattr(B, n, f)


def fam_ds_engine(cfg, mesh, device, rank):
    """deepseek-v3's engine on ``mesh``, each rank drawing the full tree
    and cutting its shards in turn (the full 4-layer tree is ~30 GB:
    two at once would not fit the shared card)."""
    import torch.distributed as dist
    eng = None
    for r in range(2):
        if r == rank:
            params = fam_draw(cfg, device)
            eng = fam_engine(cfg, params, build_expert_ticket(params, device),
                             mesh, device)
            del params
            _free(device)
        dist.barrier()
    return eng


def fam_ds_prefill(B, FA, PA, TS, eng, cfg, device) -> dict:
    """A dense prefill of ``FAM_DS_PREFILL`` tokens on the engine's
    rank-local model (no plan: what ``launch.dryrun`` traces): its
    launches by route."""
    from repro_torch.models import transformer as tfm
    gen = eng.generations[-1]
    toks = torch.arange(1, FAM_DS_PREFILL + 1, device=device)[None]
    before = routes_now(B, FA, PA, TS)
    with torch.inference_mode(), gen.sharded.scope(groups=1):
        tfm.prefill(gen.params, gen.cfg, {"tokens": toks}, FAM_DS_PREFILL)
    sync(device)
    return routes_since(before, routes_now(B, FA, PA, TS))


def fam_rank(mesh12, ds_want, opts):
    """Leg (g) on one of two ranks sharing the card over gloo: each
    family served on its meshes against the meshless engine, and
    retrained against the meshless trainer; returns its readings, the
    leg's launches by route and the kernels' entry shapes."""
    import torch.distributed as dist

    from repro_torch.core.masks import family_prunable
    from repro_torch.kernels import bsmm as B
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import tile_stats as TS
    from repro_torch.launch.mesh import make_test_mesh
    device = opts["device"]
    on_card = torch.device(device).type == "cuda"
    rank = mesh12.get_rank()
    mesh21 = make_test_mesh(2, 1, device=device, backend="gloo")
    both = (("1x2", mesh12), ("2x1", mesh21))
    out = {"rank": rank, "seconds": {}}
    t = [time.perf_counter()]

    def lap(name):
        _free(device)
        now = time.perf_counter()
        out["seconds"][name] = now - t[0]
        out.setdefault("mem_gib", {})[name] = (
            torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t[0] = now

    def ticketed(cfg, ticket):
        """() -> (seeded parameters, ``ticket(params, device)`` or None)."""
        def draw():
            params = fam_draw(cfg, device)
            return params, (ticket(params, device) if ticket else None)
        return draw

    def cast(cfg, draw32):
        """() -> ``draw32()``'s tree cast to ``cfg``'s dtypes (as its
        own initialiser gives them), and its ticket."""
        from repro_torch.core.masks import tree_flatten_with_path

        def draw():
            params32, masks = draw32()
            params = fam_draw(cfg, device)
            with torch.no_grad():
                for (_, a), (_, b) in zip(tree_flatten_with_path(params),
                                          tree_flatten_with_path(params32)):
                    a.copy_(b)
            return params, masks
        return draw

    def xl_ticket(params, device=device):
        return family_ticket(params, family_prunable("ssm"), device, 32)

    def legs():
        cfg = opts["rg"]
        params = fam_draw(cfg, device)
        out["rg_serve"] = fam_serve_meshes(
            B, FA, PA, TS, cfg, params, build_planned_ticket(params, device),
            both, device)
        del params
        lap("rg_serve")
        cfg = opts["rg_train"]
        draw = ticketed(cfg, build_planned_ticket)
        bf16 = dataclasses.replace(cfg, dtype="bfloat16")
        out["rg_train"] = fam_train(cfg, draw, both[:1], device, rank,
                                    keep=_held,
                                    witness=(bf16, cast(bf16, draw)))
        lap("rg_train")
        cfg = opts["xl"]
        params = fam_draw(cfg, device)
        masks = xl_ticket(params)
        out["xl_serve"] = fam_serve_meshes(B, FA, PA, TS, cfg, params, masks,
                                           both[:1], device)
        del params, masks
        _free(device)
        out["xl_train"] = fam_train(cfg, ticketed(cfg, xl_ticket), both[:1],
                                    device, rank)
        lap("xl")
        cfg = opts["wh"]
        params = fam_draw(cfg, device)
        out["wh_serve"] = fam_serve_meshes(B, FA, PA, TS, cfg, params, None,
                                           both[:1], device)
        del params
        _free(device)
        out["wh_train"] = fam_train(cfg, ticketed(cfg, None), both, device,
                                    rank)
        lap("wh")
        cfg = opts["ds"]
        out["ds_serve"] = fam_serve_meshes(
            B, FA, PA, TS, cfg, None, None, both[:1], device, want=ds_want,
            build=lambda mesh: fam_ds_engine(cfg, mesh, device, rank),
            after=lambda eng: fam_ds_prefill(B, FA, PA, TS, eng, cfg,
                                             device))
        out["ds_prefill"] = out["ds_serve"]["1x2"].pop("after")
        lap("ds_serve")
        cfg = opts["ds_train"]
        out["ds_train"] = fam_train(cfg, ticketed(cfg, build_expert_ticket),
                                    both[:1], device, rank,
                                    keep=_held, host=_experts)
        lap("ds_train")
        cfg = opts["l4_train"]
        # the (2, 1) leg holds the MoE layer's router and shared expert
        # and the norms (every rank trains the whole model beside them):
        # on a data axis every leaf's gradient takes the one path, the
        # rank's backward summed over the data ranks
        out["l4_train"] = fam_train(
            cfg, ticketed(cfg, build_expert_ticket), both[1:], device, rank,
            keep=lambda p: _held(p) and not _experts(p)
            and "/attn/" not in p and "/mlp/" not in p, groups=2)
        lap("l4_train")

    dist.barrier()
    before = routes_now(B, FA, PA, TS)
    _, out["batched_shapes"] = _record_batched(B, legs)
    out["launches"] = routes_since(before, routes_now(B, FA, PA, TS))
    return out


def fam_ds_meshless(opts) -> tuple:
    """deepseek-v3's meshless engine (in the parent, before the ranks:
    its full tree once on the card): its streams and logits rows."""
    device = opts["device"]
    cfg = opts["ds"]
    params = fam_draw(cfg, device)
    eng = fam_engine(cfg, params, build_expert_ticket(params, device), None,
                     device)
    del params
    with torch.inference_mode():
        want = fam_serve(eng, cfg, device)
    del eng
    _free(device)
    return want


def check_batched_at(B, cases, seed=90) -> dict:
    """#1b, #3b and #4b against their plain versions (under a seeded
    ~25 %-live union plan) at each (E, M, K, N, dtype) a rank launched
    them at, in that dtype, each call held to its rule's route and split
    count there; the largest error of each."""
    rng = np.random.default_rng(seed)
    err = {n: 0.0 for n in FAM_BATCHED}
    for name, (E, M, K, N, dtype) in cases:
        dt = getattr(torch, dtype)
        bm = random_bitmap(rng, K, N)
        plan = B.make_tile_plan(np.kron(bm, np.ones((128, 128), bool)))
        g_ = torch.Generator(device="cuda").manual_seed(E + M + K + N)
        w = (torch.randn(E, K, N, device="cuda", generator=g_)
             / K ** 0.5).to(dt)
        x = torch.randn(E, M, K, device="cuda", generator=g_).to(dt)
        g = torch.randn(E, M, N, device="cuda", generator=g_).to(dt)
        kind = {"bsmm_batched": "fwd", "bsmm_batched_dx": "dx",
                "bsmm_batched_dw": "dw"}[name]
        route, S = plan.route_and_splits(kind, M, dt, E)
        fn = getattr(B, name)
        args = {"fwd": (x, w), "dx": (g, w), "dw": (x, g)}[kind]
        got = held(fn, route, S, *args, plan)
        want = getattr(B, f"{name}_plain")(*args, plan)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        tol = tolerance(dt, want)
        print(f"check (g) {name} {dtype} E={E} M={M} K={K} N={N} {route} "
              f"splits={S} max_abs_err={e:.3e} tol={tol:.3e}")
        require(bool(torch.isfinite(got).all().item()) and e <= tol,
                f"{name} disagrees with its plain version at E={E} M={M} "
                f"K={K} N={N} {dtype}")
        err[name] = max(err[name], e)
        del w, x, g, got, want
    return err


def fam_kernel_checks(B, FA, PA, ranks) -> dict:
    """#1-#4, #1b/#3b/#4b, #7 and #8 held to their plain versions at
    every shape leg (g) launched them at on either rank (as
    ``dist_kernel_checks`` holds leg (b)'s): #1/#2 at each (K, N) and
    the rows it saw, with the gelu and silu epilogues, #3/#4 at the
    trainers' rows, the batched three at each (E, M, K, N), #8 at each
    call, #7 at each head count.  Run after the leg, so none of these
    launches counts as its."""
    serving = [leg for r in ranks for k, v in r.items()
               if k.endswith("_serve") for leg in v.values()]
    trained = [r[k]["shapes"] for r in ranks for k in r
               if k.endswith("_train")]
    fwd = [c for leg in serving for c in leg["bsmm_calls"]] + [
        tuple(c) for sh in trained for n in ("bsmm", "bsmm_epilogue")
        for c in sh.get(n, ())]
    grads = [tuple(c) for sh in trained for n in ("bsmm_dx", "bsmm_dw")
             for c in sh.get(n, ())]
    out = kernel_checks_at(
        B, FA, PA, fwd, ((None, "gelu"), (None, "silu")) + tuple(
            tuple(c) for sh in trained for c in sh.get("epilogues", ())),
        grads, sorted({tuple(c) for leg in serving
                       for c in leg["flash_calls"]}),
        [c for leg in serving for c in leg["paged_calls"] if c[1] != 1])
    cases = sorted({(n, tuple(c)) for r in ranks
                    for n, cs in r["batched_shapes"].items() for c in cs})
    with torch.inference_mode():
        out["batched_err"] = check_batched_at(
            B, [c for c in cases if c[0] == "bsmm_batched"])
    grad_err = check_batched_at(
        B, [c for c in cases if c[0] != "bsmm_batched"], seed=91)
    out["batched_err"] = {k: max(v, grad_err[k])
                          for k, v in out["batched_err"].items()}
    out["batched_cases"] = [list(c) for c in cases]
    fused = sorted({c[0] for leg in serving for c in leg["paged_calls"]
                    if c[1] == 1})
    out["fused_err"], out["fused"] = 0.0, []
    with torch.inference_mode():
        for j, hq in enumerate(fused):
            e, row = check_paged(
                PA, Hq=hq, Hkv=1, hd=576, dv=512, scale=192 ** -0.5,
                seed=95 + j,
                fused_routes={torch.bfloat16: "wgmma", torch.float32: "simt"})
            out["fused_err"] = max(out["fused_err"], e)
            out["fused"].append({"Hq": hq, "max_abs_err": e, **row})
    print(f"leg (g) kernel checks: batched {out['batched_err']} at "
          f"{len(cases)} cases, #7 at {fused} heads {out['fused_err']:.3e}")
    return out


def families_leg(B, FA, PA, opts=None) -> tuple:
    """Leg (g) (see the module docstring): deepseek-v3's meshless engine
    here, then ``fam_rank`` on two gloo ranks sharing the card, their
    readings checked, then their kernels' shapes held to the plain
    versions.  Returns (launches by kernel and rank, summary)."""
    from repro_torch.launch.mesh import run_ranks
    opts = opts or fam_options()
    device = opts["device"]
    t0 = time.perf_counter()
    ds_want = fam_ds_meshless(opts)
    if torch.device(device).type == "cuda":
        free, total = torch.cuda.mem_get_info()
        print(f"distributed (g): before the ranks, {free / 2 ** 30:.2f} of "
              f"{total / 2 ** 30:.2f} GiB free, this process holding "
              f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB", flush=True)
    ranks = run_ranks(fam_rank, 1, 2, device=device, backend="gloo",
                      args=(ds_want, opts), timeout_s=900)
    ranks_s = time.perf_counter() - t0
    rg, xl, wh, ds = (opts[k] for k in ("rg", "xl", "wh", "ds"))
    # what each family keeps whole on a model axis of 2
    whole = {
        "rg_serve": sorted([f"segments/0/{p}/rnn/conv/w" for p in (0, 1)]
                           + [f"segments/0/2/attn/{w}" for w in ("wk", "wv")]),
        "xl_serve": ["segments/0/1/rnn/down", "segments/0/1/rnn/up"],
        "wh_serve": ["frame_adapter"],
        "ds_serve": sorted(f"segments/{s}/0/attn/{w}" for s in (0, 1)
                           for w in ("w_dkv", "w_dq"))}
    heads = {"rg_serve": {"1x2": (rg.n_heads // 2, rg.n_kv_heads),
                          "2x1": (rg.n_heads, rg.n_kv_heads)},
             "xl_serve": {"1x2": (xl.n_heads, xl.n_kv_heads)},
             "wh_serve": {"1x2": (wh.n_heads // 2, wh.n_kv_heads // 2)},
             "ds_serve": {"1x2": (ds.n_heads // 2, ds.n_kv_heads // 2)}}
    for res in ranks:
        for fam in ("rg_serve", "xl_serve", "wh_serve", "ds_serve"):
            for name, leg in res[fam].items():
                print(f"distributed (g) rank {res['rank']} {fam} {name}: "
                      f"heads {leg['local_cfg']} kept whole "
                      f"{leg['kept_whole']} rel_row_err "
                      f"{leg['rel_row_err']:.3e} divergences "
                      f"{leg['greedy_divergences']} launches "
                      f"{leg['launches']}")
                require(leg["rel_row_err"] <= TEACHER_TOL,
                        f"(g) {fam} {name}: logits off the meshless "
                        "engine's")
                require(tuple(leg["local_cfg"]) == heads[fam][name],
                        f"(g) {fam} {name}: not at the local heads")
                require(leg["kept_whole"] == (whole[fam] if name == "1x2"
                                              else []),
                        f"(g) {fam} {name}: kept whole "
                        f"{leg['kept_whole']}")
                flash = leg["launches"].get("flash_attention", {})
                require(set(flash) <= {"wgmma"}, f"(g) {fam} {name}: #8 "
                        f"off its wgmma route ({flash})")
        # MLA's 64 local heads decode on #7's wgmma kernel
        fused = res["ds_serve"]["1x2"]["launches"].get("paged_attention", {})
        require(fused.get("wgmma", 0) > 0 and set(fused) == {"wgmma"},
                f"(g) deepseek: #7 at 64 heads off its wgmma route "
                f"({fused})")
        require(res["launches"].get("bsmm_batched"),
                "(g): the experts never launched #1b")
    for res in ranks[:1]:           # rank 0 holds the meshless trainer
        for fam, kernels in (("rg_train", True), ("xl_train", False),
                             ("wh_train", False), ("ds_train", True),
                             ("l4_train", True)):
            for name in ("1x2", "2x1"):
                if name in res[fam]:
                    check_train_leg(res["rank"], f"(g) {fam} {name}",
                                    res[fam][name],
                                    res[fam]["meshless_losses"],
                                    kernels=kernels)
        w = res["rg_train"]["bf16"]
        print(f"distributed (g) rank {res['rank']} rg_train bf16 1x2: losses "
              f"{w['losses']} vs meshless bf16 {w['meshless_losses']} (rel "
              f"err {w['loss_rel_err']:.3e}, tol {TP_LOSS_TOL}); gradients "
              f"{w['grad_rel_err']:.3e} of the leaf's norm off the meshless "
              f"bf16 trainer's at {w['grad_leaf']}; against float32 (gate "
              f"max({TP_GRAD_TOL}, {FAM_BF16_RATIO} x meshless bf16's), "
              f"largest slack {w['bf16_slack']:.3f}): {w['bf16_leaves']}; "
              f"first update {w['update_err_lr']:.3e} lr at "
              f"{w['update_leaf']} over {w['update_covered']} coordinates "
              f"(tol {TP_UPDATE_TOL}); launches {w['launches']} in "
              f"{w['seconds']:.1f} s")
        require(w["loss_rel_err"] <= TP_LOSS_TOL, "(g) rg_train bf16: the "
                "mesh trainer's losses are off the meshless trainer's")
        require(w["bf16_slack"] <= 1.0, "(g) rg_train bf16: a gradient "
                "is further from float32 than the meshless bf16 trainer's "
                "allows")
        require(w["update_covered"] > 0
                and w["update_err_lr"] <= TP_UPDATE_TOL, "(g) rg_train "
                "bf16: the first update is off the meshless trainer's")
        for n in TP_TRAINED:
            require(sum(w["launches"][n]["launches_by_route"].values()) > 0,
                    f"(g) rg_train bf16: the trainer never launched {n}")
    launched = {n: sum(sum(r["launches"].get(n, {}).values())
                       for r in ranks) for n in FAM_PATH}
    print(f"distributed (g): launches {launched}; rank seconds "
          f"{[r['seconds'] for r in ranks]}; peak GiB a rank "
          f"{[r['mem_gib'] for r in ranks]}")
    for n, k in launched.items():
        require(k > 0, f"leg (g) never launched {n}")
    checks = fam_kernel_checks(B, FA, PA, ranks)
    summary = {"ranks_s": ranks_s, "ranks": ranks, "kernel_checks": checks,
               "ds_prefill_launches": ranks[0]["ds_prefill"]}
    return {n: [r["launches"].get(n, {}) for r in ranks]
            for n in FAM_PATH}, summary


# ---------------------------------------------------------------------------
# 6h. the entry points: launch/{serve,train,steps}.py and the examples
# ---------------------------------------------------------------------------
LAUNCH_ARCH = "llama3.2-3b"
LAUNCH_HYBRID = "recurrentgemma-2b"
LAUNCH_SERVE = ("--requests", "16", "--max-new", "16")
LAUNCH_PRUNED = "0.75"
#: the pruned launcher's llama3.2-3b cut from 28 layers (its host prune
#: took 138-151 s at 28 on an H100's host): the script's time
LAUNCH_PRUNED_LAYERS = 8
LAUNCH_TRAIN = ("--steps", "4", "--batch", "8", "--seq", "128")
# leg (d)'s cells cut to one sequence each (published global batch: 256,
# 32, 128); LONG_500K keeps its published B = 1.  ``LAUNCH_SEQ`` shortens
# a cell's sequence for a rehearsal at a small size (empty on the card)
LAUNCH_BATCH = 1
LAUNCH_SEQ: dict = {}
LONG_PREFILL = 4096         # tokens recurrentgemma's 500k caches take first
LONG_DECODE_STEPS = 8
LAUNCH_TRAIN_STEPS = 2      # TRAIN_4K's build_step steps
LAUNCH_COUNTED = ("bsmm", "bsmm_epilogue", "paged_attention",
                  "flash_attention")
# each example at the smallest sizes its own flags allow, on the card
EXAMPLES = (
    ("quickstart",),
    ("prune_cnn_lottery", "--steps", "1", "--recipe", "paper",
     "--ticket-dir", "{tmp}/ticket"),
    ("train_lm_pruned", "--steps", "2", "--prune-steps", "1", "--batch", "1",
     "--seq", "8", "--ckpt", "{tmp}/ckpt"),
    ("serve_pruned", "--requests", "3", "--max-new", "3"),
    ("serve_control_plane", "--max-new", "2"),
)


@contextlib.contextmanager
def recorded_engines(module):
    """Within it, ``module.ServeEngine`` keeps every engine it builds (its
    ``logits_sink`` set by ``watch``) and ``module.init_params`` the time
    its parameters were ready; yields (engines, non-finite counters,
    marks: perf_counter of "params" and of the first "engine")."""
    real_engine, real_init = module.ServeEngine, module.init_params
    engines, nonfinite, marks = [], [], {}

    def init_params(*a, **kw):
        params = real_init(*a, **kw)
        marks["params"] = time.perf_counter()
        return params

    def engine(**kw):
        marks.setdefault("engine", time.perf_counter())
        marks["masks"] = kw.get("masks")
        eng = real_engine(**kw)
        nonfinite.append(watch(eng)[0])
        engines.append(eng)
        return eng

    module.ServeEngine, module.init_params = engine, init_params
    try:
        yield engines, nonfinite, marks
    finally:
        module.ServeEngine, module.init_params = real_engine, real_init


def union_tiles(masks) -> tuple:
    """(live, total) 128x128 tiles of llama's planned projections in a
    mask tree: a tile is live when any layer keeps a weight in it (the
    union a stacked segment's plan takes)."""
    live = total = 0
    for seg in masks["segments"]:
        for entry in seg:
            for group, keys in LLAMA_PROJECTIONS:
                for key in keys:
                    m = entry[group][key]
                    m = (m != 0).reshape(-1, *m.shape[-2:]).any(0)
                    K, N = m.shape
                    tiles = m.reshape(K // 128, 128, N // 128, 128).any(3)
                    tiles = tiles.any(1)
                    live += int(tiles.sum())
                    total += tiles.numel()
    return live, total


def launcher_prompt_lengths(n: int) -> list:
    """The prompt lengths ``launch.serve`` draws from RandomState(0)."""
    rng = np.random.RandomState(0)
    lengths = []
    for _ in range(n):
        k = rng.randint(4, 32)
        rng.randint(0, 200, k)
        lengths.append(k)
    return lengths


def launch_serve_leg(B, FA, PA, argv, device, label) -> tuple:
    """``launch.serve.main(argv)`` with every count set to 0 before and
    read after: every request done with its tokens, every logit finite,
    and #1/#2 by route and split, #6 and #8 (each call's length) what
    the engines' plans and passes give.  A pruned run's plan must be the
    ticket's tile union.  At ``--pruned 0.75`` on llama3.2-3b that union
    over 28 layers was every 128x128 tile (three ~37 % steps kill 32-wide
    groups spread over every tile): the skip path of #1/#2 (dead tiles
    left out of their grids) is covered by the ``serve`` phase's ~25
    %-live tickets, not here.  Returns (launches, summary)."""
    from repro_torch.configs import ATTN
    from repro_torch.launch import serve as lserve
    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm

    calls, undo = record_flash_calls((attention,))
    reset_kernel_counts(B, FA, PA)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with recorded_engines(lserve) as (engines, nonfinite, marks), \
                contextlib.redirect_stdout(buf):
            rep = lserve.main([*argv, "--device", device])
        sync(device)
    finally:
        undo()
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    print(out, end="")
    launches = kernel_counts(B, FA, PA)
    routes = bsmm_routes(B, SERVE_ROUTED)
    n_req = int(argv[argv.index("--requests") + 1])
    max_new = int(argv[argv.index("--max-new") + 1])
    cfg = engines[0].cfg
    masked = tfm.supports_masked_prefill(cfg)
    lengths = launcher_prompt_lengths(n_req)
    require(sum(e.report.prefills for e in engines) == n_req,
            f"{label}: one prefill a request")
    require(rep.requests == n_req and rep.tokens_generated == n_req * max_new,
            f"{label}: {rep.requests} requests, {rep.tokens_generated} "
            f"tokens served")
    require(sum(c[0] for c in nonfinite) == 0, f"{label}: non-finite logits")
    # one pass a prefill (its bucket) and a decode step (8 slots); with
    # one engine the plan's routes, with a fleet no plan (dense)
    rows = [engines[0]._bucket(n) if masked else n for n in lengths]
    decode_steps = [e.report.decode_steps for e in engines]
    want = expected_serving_routes(
        B, engines[0].plan, cfg, [8] * sum(decode_steps) + rows,
        SERVE_ROUTED)
    want_calls = sorted(c for S in rows for c in expected_flash_calls(cfg, S))
    global_layers = sum(k == ATTN for k in cfg.blocks)
    want_launches = {
        **{n: sum(want[n]["launches_by_route"].values())
           for n in SERVE_ROUTED},
        "paged_attention": sum(d * global_layers for e, d in
                               zip(engines, decode_steps) if e.paged),
        "paged_attention_fused_v": 0, "flash_attention": len(want_calls)}
    print(f"launch ({label}): launches {launches}, want {want_launches}; "
          f"bsmm routes {routes}, want {want}; decode steps {decode_steps}")
    require(routes == want, f"{label}: #1/#2 routes or splits off the plan")
    require(sorted(calls) == want_calls, f"{label}: flash calls off the "
            "engines' prefills")
    require(launches == want_launches, f"{label}: launch counts off the "
            "engines' passes")
    require_flash_routes(FA, len(want_calls), f"launch ({label})")
    on_card = torch.device(device).type == "cuda"
    summary = {
        "s": wall, "requests": rep.requests,
        "tokens": rep.tokens_generated, "decode_steps": decode_steps,
        "tokens_per_s": rep.tokens_per_s, "ttft_p50_s": rep.ttft_p50,
        "ttft_p95_s": rep.ttft_p95, "launches": launches,
        "bsmm_routes": routes, "report_lines": out.strip().splitlines(),
        "max_memory_allocated_bytes":
            torch.cuda.max_memory_allocated() if on_card else None}
    if "params" in marks and "engine" in marks:
        summary["prune_s"] = marks["engine"] - marks["params"]
    if marks.get("masks") is not None:
        live, total = union_tiles(marks["masks"])
        print(f"launch ({label}): live tiles {rep.live_tiles}/"
              f"{rep.total_tiles}, the ticket's union {live}/{total}")
        require(rep.bsmm_enabled and (rep.live_tiles, rep.total_tiles)
                == (live, total), f"{label}: the engine's plan is not the "
                "ticket's tile union")
    if len(engines) == 1:
        summary.update(bsmm=rep.bsmm_enabled,
                       live_tiles=rep.live_tiles, total_tiles=rep.total_tiles,
                       skipped_tile_fraction=rep.skipped_tile_fraction,
                       slot_occupancy=rep.slot_occupancy)
    else:
        summary.update(failovers=rep.failovers, live_engines=rep.live_engines,
                       redispatched=rep.redispatched)
    del engines, rep
    return launches, summary


def launch_train_leg(B, FA, PA, device) -> tuple:
    """``launch.train.main`` at full width and depth (dense, plain
    attention: no kernel): each step timed (``Trainer.step_fn`` wrapped,
    the card synchronised), finite losses, ``done at step 4``, the peak."""
    from repro_torch._bridge import tree_leaves
    from repro_torch.launch import train as ltrain

    real = ltrain.Trainer
    steps = []

    class Timed(real):
        def __init__(self, **kw):
            super().__init__(**kw)
            inner = self.step_fn

            def timed(*args):
                t = time.perf_counter()
                out = inner(*args)
                sync(device)
                steps.append((time.perf_counter() - t,
                              float(out[-1]["loss"])))
                return out
            self.step_fn = timed

    reset_kernel_counts(B, FA, PA)
    reset_bsmm_routes(B)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    ltrain.Trainer = Timed
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            trainer = ltrain.main(["--arch", LAUNCH_ARCH, *LAUNCH_TRAIN,
                                   "--device", device])
    finally:
        ltrain.Trainer = real
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    print(out, end="")
    n = int(LAUNCH_TRAIN[LAUNCH_TRAIN.index("--steps") + 1])
    launches = {**kernel_counts(B, FA, PA),
                **{k: getattr(B, k).launches for k in BSMM_ROUTED}}
    losses = [loss for _, loss in steps]
    times = [t for t, _ in steps]
    print(f"launch (train): {n} steps, losses {losses}, step s {times}, "
          f"launches {launches}")
    require(f"done at step {n}" in out and trainer.state.step == n,
            "launch.train.main did not reach its last step")
    require(len(steps) == n and all(np.isfinite(losses)),
            "launch.train.main's losses are not finite")
    require(not any(launches.values()), "the dense train path launched a "
            "kernel")
    params = sum(t.numel() for t in tree_leaves(trainer.state.params))
    del trainer
    return launches, {
        "s": wall, "steps": n, "losses": losses, "step_s": times,
        "step_s_median_2_4": float(np.median(times[1:])),
        "parameters": params,
        "max_memory_allocated_bytes":
            torch.cuda.max_memory_allocated() if on_card else None}


def launch_cell(shape):
    """A shape cell as leg (d) runs it: ``LAUNCH_BATCH`` sequences (but
    LONG_500K, published at 1), its sequence ``LAUNCH_SEQ``'s if set."""
    batch = shape.global_batch if shape.name == "long_500k" else LAUNCH_BATCH
    return dataclasses.replace(shape, global_batch=batch,
                               seq_len=LAUNCH_SEQ.get(shape.name,
                                                      shape.seq_len))


def spec_inputs(spec: dict, vocab: int, gen, device) -> dict:
    """Random integer inputs of ``input_specs``'s meta shapes and dtypes."""
    return {k: torch.randint(0, vocab, tuple(s.shape), generator=gen,
                             device=device, dtype=s.dtype)
            for k, s in spec.items()}


def shapes_of(tree) -> list:
    from repro_torch._bridge import tree_leaves
    return [tuple(t.shape) for t in tree_leaves(tree)]


def launch_cells_leg(B, FA, PA, device) -> tuple:
    """``build_step``'s cells on llama3.2-3b at full width and depth:
    TRAIN_4K (two steps), PREFILL_32K then DECODE_32K on its caches
    against one prefill of every token (5e-2 of each row's max |logit|),
    LONG_500K's skip; then recurrentgemma-2b's LONG_500K decode from a
    ``LONG_PREFILL``-token prefill at its capacity.  Each timed cell
    records its first step's launches by wrapper and route and its peak
    (the dry-run phase's cross-check reads them).  Returns (launches,
    summary)."""
    from repro_torch._bridge import tree_leaves
    from repro_torch.configs import (ATTN, DECODE_32K, LONG_500K,
                                     PREFILL_32K, TRAIN_4K, get_arch)
    from repro_torch.kernels import tile_stats as TS
    from repro_torch.launch import steps as lsteps
    from repro_torch.models import transformer as tfm

    on_card = torch.device(device).type == "cuda"
    snap = lambda: routes_now(B, FA, PA, TS)        # noqa: E731

    def peak():
        return torch.cuda.max_memory_allocated() if on_card else None

    def reset_peak():
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    summary = {}
    cfg = get_arch(LAUNCH_ARCH)
    gen = torch.Generator(device=device).manual_seed(0)
    params = tfm.init_params(gen, cfg, device=device)
    reset_kernel_counts(B, FA, PA)

    # TRAIN_4K: the meta specs drive the inputs; two steps
    cell = launch_cell(TRAIN_4K)
    train = lsteps.build_step(cfg, cell)
    require(train.kind == "train" and shapes_of(train.args[0])
            == shapes_of(params), "train_4k: params_spec off the params")
    opt_state = lsteps.make_optimizer(cfg).init(params)
    require(shapes_of(train.args[1]) == shapes_of(opt_state),
            "train_4k: opt_state_spec off the optimizer state")
    batch = spec_inputs(train.args[2], cfg.vocab_size, gen, device)
    reset_peak()
    p, losses, times = params, [], []
    for i in range(LAUNCH_TRAIN_STEPS):
        before = snap()
        t = time.perf_counter()
        p, opt_state, metrics = train.fn(p, opt_state, batch)
        sync(device)
        times.append(time.perf_counter() - t)
        losses.append(float(metrics["loss"]))
        if i == 0:
            train_routes = routes_since(before, snap())
    summary["train_4k"] = {"batch": cell.global_batch, "seq": cell.seq_len,
                           "losses": losses, "step_s": times,
                           "launches_by_route": train_routes,
                           "max_memory_allocated_bytes": peak()}
    print(f"launch (cells) train_4k at B = {cell.global_batch}: "
          f"{summary['train_4k']}")
    require(all(np.isfinite(losses)), "train_4k: non-finite loss")
    del p, opt_state, batch, metrics
    _free(device)

    # PREFILL_32K fed S - 1 tokens, then DECODE_32K on its caches with
    # token S, against one prefill of all S tokens
    pre = lsteps.build_step(cfg, launch_cell(PREFILL_32K))
    dec = lsteps.build_step(cfg, launch_cell(DECODE_32K))
    S = launch_cell(PREFILL_32K).seq_len
    tokens = spec_inputs(pre.args[1], cfg.vocab_size, gen, device)["tokens"]
    reset_kernel_counts(B, FA, PA)
    reset_peak()
    before = snap()
    t = time.perf_counter()
    _, caches = pre.fn(params, {"tokens": tokens[:, :-1]})
    sync(device)
    prefill_s = time.perf_counter() - t
    prefill_peak = peak()
    prefill_routes = routes_since(before, snap())
    require(shapes_of(caches) == shapes_of(dec.args[1]),
            "decode_32k: the prefill's caches are not cache_specs'")
    reset_peak()
    before = snap()
    t = time.perf_counter()
    logits, caches = dec.fn(params, caches, tokens[:, -1:])
    sync(device)
    decode_s = time.perf_counter() - t
    decode_peak, decode_routes = peak(), routes_since(before, snap())
    del caches
    _free(device)
    full, caches = pre.fn(params, {"tokens": tokens})
    del caches
    err = ((logits.float() - full.float()).abs().amax(-1)
           / full.float().abs().amax(-1).clamp_min(1e-30)).max().item()
    flash = FA.flash_attention.launches
    global_layers = sum(k == ATTN for k in cfg.blocks)
    summary["prefill_decode_32k"] = {
        "batch": LAUNCH_BATCH, "prefill_tokens": S - 1, "prefill_s": prefill_s,
        "prefill_max_memory_allocated_bytes": prefill_peak,
        "prefill_launches_by_route": prefill_routes,
        "decode_s": decode_s, "decode_max_memory_allocated_bytes": decode_peak,
        "decode_launches_by_route": decode_routes,
        "decode_vs_full_prefill_rel_err": err,
        "tol": TEACHER_TOL, "flash_launches": flash,
        "logits_finite": bool(torch.isfinite(logits).all())}
    print(f"launch (cells) prefill_32k + decode_32k: "
          f"{summary['prefill_decode_32k']}")
    require(summary["prefill_decode_32k"]["logits_finite"],
            "decode_32k: non-finite logits")
    require(err <= TEACHER_TOL, "decode_32k after prefill_32k is off the "
            "full prefill's last row")
    require(flash == 2 * global_layers, "prefill_32k: #8 not once a layer "
            "and prefill")
    require_flash_routes(FA, 2 * global_layers, "launch (cells) prefill_32k")
    launches = kernel_counts(B, FA, PA)
    skip = lsteps.cell_skip_reason(cfg, LONG_500K)
    print(f"launch (cells) {cfg.name} x long_500k: SKIP ({skip})")
    require(skip is not None, "long_500k is not skipped for a full-attention "
            "arch")
    summary["long_500k_skip"] = {cfg.name: skip}
    del params, logits, full, tokens
    _free(device)

    # LONG_500K on recurrentgemma-2b at its published B = 1
    rg = get_arch(LAUNCH_HYBRID)
    require(lsteps.cell_skip_reason(rg, LONG_500K) is None,
            "recurrentgemma-2b's long_500k is skipped")
    long = launch_cell(LONG_500K)
    rg_params = tfm.init_params(gen, rg, device=device)
    prefill_cell = type(long)("long_500k_prefill", long.seq_len,
                              long.global_batch, "prefill")
    rpre = lsteps.build_step(rg, prefill_cell)
    rdec = lsteps.build_step(rg, long)
    toks = torch.randint(0, rg.vocab_size, (long.global_batch, LONG_PREFILL),
                         generator=gen, device=device, dtype=torch.int32)
    reset_peak()
    t = time.perf_counter()
    logits, caches = rpre.fn(rg_params, {"tokens": toks})
    sync(device)
    rprefill_s = time.perf_counter() - t
    require(shapes_of(caches) == shapes_of(rdec.args[1]),
            "long_500k: the prefill's caches are not cache_specs'")
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(caches))
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    finite, times = bool(torch.isfinite(logits).all()), []
    del logits
    reset_peak()
    for i in range(LONG_DECODE_STEPS):
        before = snap()
        t = time.perf_counter()
        logits, caches = rdec.fn(rg_params, caches, tok)
        sync(device)
        times.append(time.perf_counter() - t)
        if i == 0:
            long_routes = routes_since(before, snap())
        finite &= bool(torch.isfinite(logits).all())
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
    summary["long_500k"] = {
        "arch": rg.name, "batch": long.global_batch,
        "capacity": long.seq_len, "prefill_tokens": LONG_PREFILL,
        "prefill_s": rprefill_s, "decode_steps": LONG_DECODE_STEPS,
        "decode_step_s": times, "cache_bytes": cache_bytes,
        "decode_launches_by_route": long_routes,
        "logits_finite": finite,
        "decode_max_memory_allocated_bytes": peak()}
    print(f"launch (cells) {rg.name} x long_500k: {summary['long_500k']}")
    require(finite, "long_500k: non-finite logits")
    del rg_params, caches, logits
    _free(device)
    return launches, summary


def launch_examples_leg(device) -> dict:
    """The five ``examples/torch_*.py`` at once as subprocesses (their
    default device, the card), each at the smallest sizes its flags
    allow, its output in ``chiprun_out/``: each must exit 0; its own
    seconds (start to exit, all running together) and last line printed."""
    OUT.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="launch_examples_"))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs, out = {}, {}
    try:
        for name, *args in EXAMPLES:
            d = tmp / name
            d.mkdir()
            cmd = [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"),
                   *(a.format(tmp=d) for a in args)]
            if torch.device(device).type != "cuda":
                cmd += ["--device", device]
            log = OUT / f"launch_example_{name}.log"
            with open(log, "w") as f:
                procs[name] = (time.perf_counter(), log, subprocess.Popen(
                    cmd, cwd=ROOT, env=env, stdout=f,
                    stderr=subprocess.STDOUT, text=True))
        deadline = time.perf_counter() + 600
        while len(out) < len(procs) and time.perf_counter() < deadline:
            for name, (t0, log, proc) in procs.items():
                if name not in out and proc.poll() is not None:
                    lines = log.read_text().strip().splitlines() or [""]
                    out[name] = {"rc": proc.returncode,
                                 "s": time.perf_counter() - t0,
                                 "last_line": lines[-1]}
                    print(f"launch (examples) torch_{name}.py: {out[name]}")
                    if proc.returncode:
                        print("\n".join(lines[-40:]), file=sys.stderr)
            time.sleep(0.05)
    finally:
        for _, _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    for name, _ in procs.items():
        require(name in out, f"examples/torch_{name}.py did not end")
        require(out[name]["rc"] == 0,
                f"examples/torch_{name}.py exited {out[name]['rc']}")
    return out


def launch_phase(B, FA, PA, device="cuda") -> tuple:
    """Legs (a)-(e) of the entry points (see the module docstring);
    returns (#1/#2/#6/#8 launches by leg, summary)."""
    summary, legs, t = {}, {}, time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        summary.setdefault("leg_s", {})[name] = now - t
        t = now

    from repro_torch.configs import get_arch, register
    base = get_arch(LAUNCH_ARCH)
    cut = register(dataclasses.replace(
        base, n_layers=LAUNCH_PRUNED_LAYERS,
        name=f"{base.name}-{LAUNCH_PRUNED_LAYERS}l"))
    legs["serve_pruned"], summary["serve_pruned"] = launch_serve_leg(
        B, FA, PA, ["--arch", cut.name, "--pruned", LAUNCH_PRUNED,
                    *LAUNCH_SERVE], device, "pruned serving")
    require(summary["serve_pruned"]["bsmm"], "the pruned launcher served "
            "dense")
    _free(device)
    lap("serve_pruned")
    hb = tempfile.mkdtemp(prefix="launch_heartbeat_")
    try:
        legs["fleet"], summary["fleet"] = launch_serve_leg(
            B, FA, PA, ["--arch", LAUNCH_ARCH, *LAUNCH_SERVE, "--engines",
                        "2", "--heartbeat-dir", hb], device, "dense fleet")
    finally:
        shutil.rmtree(hb, ignore_errors=True)
    f = summary["fleet"]
    require(f["failovers"] == 0 and f["live_engines"] == 2,
            "the dense fleet failed over")
    _free(device)
    lap("fleet")
    legs["train"], summary["train"] = launch_train_leg(B, FA, PA, device)
    _free(device)
    lap("train")
    legs["cells"], summary["cells"] = launch_cells_leg(B, FA, PA, device)
    lap("cells")
    summary["examples"] = launch_examples_leg(device)
    lap("examples")
    launches = {name: {leg: c.get(name, 0) for leg, c in legs.items()}
                for name in LAUNCH_COUNTED}
    print(f"launch: launches by leg {launches}; leg seconds "
          f"{summary['leg_s']}")
    return launches, summary


# ---------------------------------------------------------------------------
# 6i. the dry-run: rank 0 of the production mesh traced on fake tensors
# ---------------------------------------------------------------------------
DRYRUN_ARCH = "llama3.2-3b"         # every shape, on 16x16 and 2x16x16
DRYRUN_OTHERS = "prefill_32k"       # every other arch's cell, on 16x16


def dryrun_cells(smi: str, archs) -> dict:
    """Leg (a): ``launch.dryrun.run_cell`` on every shape of
    ``DRYRUN_ARCH`` on both production meshes and on ``DRYRUN_OTHERS``
    of every other of ``archs`` on 16x16, one line a cell; every cell OK
    or SKIP (every family runs on the production mesh)."""
    from repro_torch.configs import ALL_SHAPES
    from repro_torch.launch import dryrun

    cells = [(DRYRUN_ARCH, s.name, mp) for s in ALL_SHAPES
             for mp in (False, True)]
    cells += [(a, DRYRUN_OTHERS, False) for a in archs if a != DRYRUN_ARCH]
    recs, counts = [], {"OK": 0, "SKIP": 0, "FAIL": 0}
    for arch, shape, mp in cells:
        rec = dryrun.run_cell(arch, shape, multi_pod=mp)
        print(f"dryrun [{smi}] {dryrun.cell_line(rec)}", flush=True)
        counts[rec["status"]] += 1
        require(rec["status"] != "FAIL",
                f"dryrun {arch} x {shape}: {rec.get('error')}")
        recs.append(rec)
    (OUT / "dryrun_results.json").write_text(json.dumps(recs, indent=1))
    return {"counts": counts, "cells": [
        {k: r.get(k) for k in ("arch", "shape", "mesh", "status")}
        | ({"GiB_per_device": r["memory"]["total_bytes_per_device"] / 2 ** 30,
            "bottleneck": r["roofline"]["bottleneck"],
            "step_time_s": max(r["roofline"][k] for k in (
                "compute_s", "memory_s", "collective_s")),
            "trace_s": r["compile_s"]} if r["status"] == "OK" else {})
        for r in recs]}


def dryrun_cross_check(smi: str, cells: dict) -> dict:
    """Leg (b): the launch phase's measured cells traced at the same cut
    on a (1, 1) mesh: launches by wrapper and route equal to the real
    step's, the roofline step time at or below the measured one, and the
    predicted bytes a device (arguments + temporaries) printed beside
    ``max_memory_allocated``."""
    import dataclasses

    from repro_torch.configs import (DECODE_32K, LONG_500K, PREFILL_32K,
                                     TRAIN_4K, get_arch)
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import roofline_from_trace

    one = {"data": 1, "model": 1}
    llama, rg = get_arch(LAUNCH_ARCH), get_arch(LAUNCH_HYBRID)
    pd = cells["prefill_decode_32k"]
    S = launch_cell(PREFILL_32K).seq_len
    rows = (
        ("train_4k", llama, launch_cell(TRAIN_4K), {},
         cells["train_4k"]["launches_by_route"],
         min(cells["train_4k"]["step_s"]),
         cells["train_4k"]["max_memory_allocated_bytes"]),
        ("prefill_32k", llama, launch_cell(PREFILL_32K),
         {"prefill_tokens": S - 1}, pd["prefill_launches_by_route"],
         pd["prefill_s"], pd["prefill_max_memory_allocated_bytes"]),
        ("decode_32k", llama, launch_cell(DECODE_32K), {},
         pd["decode_launches_by_route"], pd["decode_s"],
         pd["decode_max_memory_allocated_bytes"]),
        ("long_500k", rg, launch_cell(LONG_500K), {},
         cells["long_500k"]["decode_launches_by_route"],
         min(cells["long_500k"]["decode_step_s"]),
         cells["long_500k"]["decode_max_memory_allocated_bytes"]))
    out = {}
    for name, cfg, shape, kw, launched, measured_s, peak in rows:
        tr, out_bytes = dryrun.trace_cell(cfg, shape, one, **kw)
        terms = roofline_from_trace(tr, 1)
        mem = dryrun.memory_dict(tr, out_bytes)
        predicted = mem["total_bytes_per_device"]
        row = {"arch": cfg.name, "batch": shape.global_batch,
               "seq": shape.seq_len, **kw,
               "traced_launches": tr.launches(), "real_launches": launched,
               "roofline_step_s": terms.step_time_s,
               "bottleneck": terms.bottleneck, "measured_step_s": measured_s,
               "predicted_bytes": predicted,
               "max_memory_allocated_bytes": peak,
               "predicted_over_measured_bytes":
                   predicted / peak if peak else None,
               "trace_s": tr.host_s}
        print(f"dryrun [{smi}] cross-check {cfg.name} x {name} (1x1, B = "
              f"{shape.global_batch}): launches traced {row['traced_launches']}"
              f" real {launched}; roofline {terms.step_time_s:.4e} s "
              f"({terms.bottleneck}) vs measured {measured_s:.4e} s; "
              f"bytes predicted {predicted} vs max_memory_allocated {peak} "
              f"({row['predicted_over_measured_bytes']})", flush=True)
        require(row["traced_launches"] == launched, f"dryrun {name}: the "
                "trace's launches differ from the real step's")
        require(terms.step_time_s <= measured_s, f"dryrun {name}: the "
                "roofline step time is above the measured one")
        out[name] = row
        del tr
    return out


def dryrun_family_check(smi: str, launched: dict) -> dict:
    """Leg (c): deepseek-v3 at leg (g)'s cut (4 layers, 256 experts), a
    dense prefill of ``FAM_DS_PREFILL`` tokens traced on rank 0 of a (1,
    2) ``AbstractMesh``: its launches by wrapper and route equal to what
    leg (g)'s rank 0 launched for the same prefill (MLA's 64 local heads
    through #8)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    shape = ShapeSpec("fam_prefill", FAM_DS_PREFILL, 1, "prefill")
    tr, _ = dryrun.trace_cell(deepseek_config(), shape,
                              {"data": 1, "model": 2})
    traced = tr.launches()
    print(f"dryrun [{smi}] leg (g)'s deepseek prefill on 1x2: launches "
          f"traced {traced} real {launched}", flush=True)
    require(traced == launched, "dryrun: the traced 1x2 deepseek prefill's "
            "launches differ from leg (g)'s rank 0")
    return {"traced": traced, "real": launched, "trace_s": tr.host_s}


def dryrun_phase(smi: str, launch_summary: dict, archs=None,
                 family_launches=None) -> dict:
    """Leg (a) ``dryrun_cells`` over ``archs`` (default: every registered
    arch), leg (b) ``dryrun_cross_check`` against the launch phase's
    cells, leg (c) ``dryrun_family_check`` against leg (g)'s rank 0
    (``family_launches``)."""
    from repro_torch.configs import list_archs
    t0 = time.perf_counter()
    summary = dryrun_cells(smi, archs or list_archs())
    summary["cells_s"] = time.perf_counter() - t0
    require(summary["counts"]["FAIL"] == 0, "dryrun: a cell failed")
    t1 = time.perf_counter()
    summary["cross_check"] = dryrun_cross_check(smi, launch_summary["cells"])
    if family_launches is not None:
        summary["family_check"] = dryrun_family_check(smi, family_launches)
    summary["cross_check_s"] = time.perf_counter() - t1
    print(f"dryrun [{smi}]: {summary['counts']} in {summary['cells_s']:.1f} "
          f"s; cross-check in {summary['cross_check_s']:.1f} s")
    return summary


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the port "
              "on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch, list_archs
    from repro_torch.kernels import _build
    from repro_torch.kernels import bsmm as B
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import tile_stats as TS

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    OUT.mkdir(exist_ok=True)

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    (OUT / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    print(f"build: {build_s:.1f} s ({', '.join(logs) or 'cached'})")

    cfg = get_arch("llama3.2-3b")
    # the published archs, before a phase registers a cut variant
    published = list(list_archs())
    phases = {"build": build_s}
    new_runs = {}
    mark = [time.perf_counter()]

    def phase(name):                 # seconds since the last mark
        now = time.perf_counter()
        phases[name] = now - mark[0]
        mark[0] = now

    with torch.inference_mode():
        bsmm_err, bsmm_times = check_bsmm(B)
        paged_err, paged_row = check_paged(PA)
        grad_err, grad_times = check_bsmm_grads(B)
        # deepseek-v3's absorbed MLA: one latent head of r + dr = 576
        # lanes under 128 query heads, values its first 512, scale
        # 1/sqrt(qk_nope + qk_rope)
        mla_err, mla_row = check_paged(
            PA, Hq=128, Hkv=1, hd=576, dv=512, scale=192 ** -0.5, seed=11,
            fused_routes={torch.bfloat16: "wgmma", torch.float32: "simt"})
        # phi-3-vision's decode: 32 query and KV heads of 96 (dv / 2 = 48
        # lanes: 5 token groups of the p @ v pass, 16 threads idle)
        hd96_err, hd96_row = check_paged(PA, Hq=32, Hkv=32, hd=96, seed=19)
        batched_err, batched_times = check_bsmm_batched(B)
        bgrad_err, bgrad_times = check_bsmm_batched_grads(B)
        batched_err = max(batched_err, bgrad_err["bsmm_batched"])
        # the dense FFN's gate and the shared expert's run the epilogue
        # with silu and no bias
        ds_err, _ = check_bsmm(B, DEEPSEEK_BSMM_SHAPES, DEEPSEEK_BSMM_ROWS,
                               ((None, "silu"),), timed=False, seed=5)
        bsmm_err = {k: max(v, ds_err[k]) for k, v in bsmm_err.items()}
        # dx and dw at the retrain's 1024 rows on the same shapes
        ds_grad_err, _ = check_bsmm_grads(B, DEEPSEEK_BSMM_SHAPES,
                                          timed=False, seed=8)
        grad_err = {k: max(v, ds_grad_err[k]) for k, v in grad_err.items()}
        # recurrentgemma-2b's projections (the gate's gelu epilogue) and
        # command-r-35b's (silu), at decode and retrain rows; #3/#4 at
        # recurrentgemma's at the retrain's rows
        for shapes, act, seed in ((RG_BSMM_SHAPES, "gelu", 21),
                                  (CR_BSMM_SHAPES, "silu", 22)):
            new_err, _ = check_bsmm(B, shapes, NEW_BSMM_ROWS,
                                    ((None, act),), timed=False, seed=seed)
            bsmm_err = {k: max(v, new_err[k]) for k, v in bsmm_err.items()}
        rg_grad_err, _ = check_bsmm_grads(B, RG_BSMM_SHAPES, timed=False,
                                          seed=23)
        grad_err = {k: max(v, rg_grad_err[k]) for k, v in grad_err.items()}
        # llama4-maverick's projections (silu gate) at decode and prompt
        # rows, its 64 experts at every serving capacity; #1-#4 at
        # phi-3-vision's retrain rows
        for shapes, rows_, seed in ((LLAMA4_BSMM_SHAPES, LLAMA4_BSMM_ROWS, 26),
                                    (VLM_BSMM_SHAPES, VLM_RETRAIN_ROWS, 28)):
            new_err, _ = check_bsmm(B, shapes, rows_, ((None, "silu"),),
                                    timed=False, seed=seed)
            bsmm_err = {k: max(v, new_err[k]) for k, v in bsmm_err.items()}
        caps = llama4_capacities()
        l4_batched_err, l4_batched_times = check_bsmm_batched(
            B, LLAMA4_EXPERTS, LLAMA4_EXPERT_SHAPES, caps, timed=caps, seed=27)
        batched_err = max(batched_err, l4_batched_err)
        vlm_grad_err, _ = check_bsmm_grads(B, VLM_BSMM_SHAPES, timed=False,
                                           seed=29, rows=VLM_RETRAIN_ROWS)
        grad_err = {k: max(v, vlm_grad_err[k]) for k, v in grad_err.items()}
        stats_err, stats_times = check_tile_stats(TS)
        masked_err, masked_times, masked_smem = check_masked(B)
        # the wgmma ring of #1/#2/#4: two blocks an SM, or one alone
        bsmm_smem = {"two_an_sm": B.wgmma_smem_bytes(False),
                     "alone": B.wgmma_smem_bytes(True)}
        print(f"bsmm wgmma dynamic shared memory: {bsmm_smem}")
        flash_err, flash_times = check_flash(FA)
    flash_build = flash_build_report(FA, logs.get("flash_attention", ""))
    phase("kernel_checks")
    with torch.inference_mode():
        ltp_summary = ltp_mlp(cfg, "cuda")
    phase("ltp_mlp")
    torch.cuda.empty_cache()
    launches, summary = serve(cfg, "cuda", dispatch=True)
    phase("serve")
    # the serve phase's model is gone; the control plane holds two
    # tickets' weights, all freed before the retrain phase's 56.5 GB peak
    gc.collect()
    torch.cuda.empty_cache()
    # the control plane at full width cut to CP_LAYERS of its 28 layers,
    # so that the script fits its time with the entry points' phase (at
    # 28 the whole script took 807 s on an H100 80GB HBM3 at 700 W, the
    # control plane 108 s of it; its full-scale CLI call keeps 28)
    cp_launches, cp_summary = control_plane(
        dataclasses.replace(cfg, n_layers=CP_LAYERS), "cuda")
    phase("control_plane")
    gc.collect()
    torch.cuda.empty_cache()
    grad_summary = grad_check(cfg, "cuda")
    t_launches, train_summary = retrain(cfg, "cuda")
    phase("grad_check_retrain")
    gc.collect()
    torch.cuda.empty_cache()
    # the LM pruning program, with the 2-D bsmm counts set to 0 just
    # before and read just after
    reset_bsmm_routes(B)
    lm_summary = lm_session("cuda")
    lm_launches = {n: getattr(B, n).launches for n in BSMM_ROUTED}
    print(f"lm_session launches {lm_launches}")
    for name, n in lm_launches.items():
        require(n > 0, f"the LM session never launched {name}")
    phase("lm_session")
    # the llama models are gone (each phase's locals); hand their memory
    # back before the ~30 GB deepseek-v3 model is drawn
    gc.collect()
    torch.cuda.empty_cache()
    ds_launches, ds_summary = serve_deepseek(deepseek_config(), "cuda")
    phase("serve_deepseek")
    # the serving model's ~30 GB must be gone before the retrain's ~65 GB
    gc.collect()
    torch.cuda.empty_cache()
    moe_grad_summary = moe_grad_check(deepseek_retrain_config(), "cuda")
    gc.collect()
    torch.cuda.empty_cache()
    rd_launches, rd_summary = retrain_deepseek(deepseek_retrain_config(),
                                               "cuda")
    phase("retrain_deepseek")
    # deepseek-v3's models are gone; recurrentgemma-2b at its published
    # size (5.3 GB of bf16 parameters), then its ticket retrained
    gc.collect()
    torch.cuda.empty_cache()
    hy_launches, hy_summary = serve_hybrid(get_arch("recurrentgemma-2b"),
                                           "cuda")
    phase("serve_hybrid")
    gc.collect()
    torch.cuda.empty_cache()
    rh_launches, rh_summary = retrain_lm("cuda")
    phase("retrain_hybrid")
    gc.collect()
    torch.cuda.empty_cache()
    cr_launches, cr_summary = serve(command_r_config(), "cuda",
                                    max_new=CR_MAX_NEW, label="command-r")
    phase("serve_command_r")
    # the last four families, each phase's model freed before the next
    for name, fn in (("serve_xlstm", lambda: serve_xlstm("cuda")),
                     ("retrain_xlstm",
                      lambda: retrain_lm("cuda", arch="xlstm-125m",
                                         ticket_seed=32)),
                     ("serve_whisper", lambda: serve_whisper("cuda")),
                     ("retrain_whisper", lambda: retrain_whisper("cuda")),
                     ("serve_vlm", lambda: serve_vlm("cuda")),
                     ("retrain_vlm",
                      lambda: retrain_lm("cuda", arch=vlm_retrain_config(),
                                         seq_len=VLM_SEQ)),
                     ("serve_llama4", lambda: serve_llama4("cuda"))):
        gc.collect()
        torch.cuda.empty_cache()
        new_runs[name] = fn()
        phase(name)
    # distribution: legs (a)-(e), with the llama4 model gone
    gc.collect()
    torch.cuda.empty_cache()
    dist_launches, dist_summary = distributed_phase(B, FA, PA)
    phase("distributed")
    # ... its leg (g): the last families on a mesh
    gc.collect()
    torch.cuda.empty_cache()
    fam_launches, fam_summary = families_leg(B, FA, PA)
    phase("distributed_g")
    # the entry points a user starts the port with: legs (a)-(e)
    gc.collect()
    torch.cuda.empty_cache()
    launch_launches, launch_summary = launch_phase(B, FA, PA)
    phase("launch")
    # the dry-run: rank 0 of the production mesh on fake tensors, and the
    # launch phase's cells traced at their cut against their measurements
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_summary = dryrun_phase(smi, launch_summary, published,
                                  fam_summary["ds_prefill_launches"])
    phase("dryrun")
    xl_launches, xl_summary = new_runs["serve_xlstm"]
    _, rx_summary = new_runs["retrain_xlstm"]
    wh_launches, wh_summary = new_runs["serve_whisper"]
    rw_summary = new_runs["retrain_whisper"]
    vl_launches, vl_summary = new_runs["serve_vlm"]
    rv_launches, rv_summary = new_runs["retrain_vlm"]
    l4_launches, l4_summary = new_runs["serve_llama4"]
    del new_runs
    # deepseek-v3's models are gone with their phases; the CNN slice
    # needs a few GB
    gc.collect()
    torch.cuda.empty_cache()
    cnn_launches, cnn_summary = cnn_phase("cuda")
    resnet_summary = resnet_step_check()
    cnn_summary["resnet18_step_check"] = resnet_summary
    phase("cnn")
    # the sparsity lint, after every earlier phase (their held counts
    # are read) and outside inference mode (it differentiates a step)
    gc.collect()
    torch.cuda.empty_cache()
    lint_launches, lint_summary = lint_phase(B, FA, PA, TS)
    phase("lint")

    def new_path_launches(name):
        """A 2-D bsmm wrapper's launches on the later slices' paths."""
        out = {"launches_retrain_hybrid": rh_launches[name],
               "launches_retrain_vlm": rv_launches[name]}
        if name in hy_launches:
            out["launches_serve_hybrid"] = hy_launches[name]
            out["launches_serve_command_r"] = cr_launches[name]
            out["launches_serve_vlm"] = vl_launches[name]
            out["launches_serve_llama4"] = l4_launches[name]
        return out

    rep_row = next(r for r in bsmm_times if r["M"] == 8 and r["N"] == 8192)
    grad_row = next(r for r in grad_times if r["N"] == 8192)
    # the expert up/gate shape at decode rows, and at the retrain's
    # capacity (the batched forward, dx and dw)
    batched_row = next(r for r in batched_times
                       if r["M"] == 8 and r["N"] == 2048)
    bgrad_row = next(r for r in bgrad_times if r["N"] == 2048)
    serve_routes = summary["bsmm_routes"]
    kernels = [
        {"name": "bsmm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bsmm.cu",
         "replaces": "src/repro/kernels/bsmm.py:118",
         "launches": launches["bsmm"], **serve_routes["bsmm"],
         "launches_lm_session": lm_launches["bsmm"],
         **new_path_launches("bsmm"),
         "max_abs_err": bsmm_err["bsmm"],
         "ms": rep_row["bsmm_ms"], "plain_ms": rep_row["plain_ms"],
         "bound_ms": rep_row["bound_ms"], "bound_by": rep_row["bound_by"],
         "library_ms": rep_row["matmul_ms"]},
        {"name": "bsmm_epilogue", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bsmm.cu",
         "replaces": "src/repro/kernels/bsmm.py:136",
         "launches": launches["bsmm_epilogue"],
         **serve_routes["bsmm_epilogue"],
         "launches_lm_session": lm_launches["bsmm_epilogue"],
         **new_path_launches("bsmm_epilogue"),
         "max_abs_err": bsmm_err["bsmm_epilogue"],
         "ms": rep_row["bsmm_epilogue_ms"],
         "plain_ms": rep_row["epilogue_plain_ms"],
         "bound_ms": rep_row["bound_ms"], "bound_by": rep_row["bound_by"],
         "library_ms": None},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:171",
         "launches": launches["paged_attention"],
         "launches_serve_command_r": cr_launches["paged_attention"],
         # phi-3-vision's head width, launches from its serving phase
         "hd96": {"launches_serve_vlm": vl_launches["paged_attention"],
                  "max_abs_err": hd96_err,
                  **{k: hd96_row[k] for k in ("Hq", "Hkv", "ms", "plain_ms",
                                              "bound_ms", "bound_by",
                                              "library_ms")}},
         "max_abs_err": paged_err,
         "ms": paged_row["ms"], "plain_ms": paged_row["plain_ms"],
         "bound_ms": paged_row["bound_ms"], "bound_by": paged_row["bound_by"],
         "library_ms": paged_row["library_ms"]},
    ]
    for kind, line in (("dx", 322), ("dw", 399)):
        kernels.append(
            {"name": f"bsmm_{kind}", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/bsmm.cu",
             "replaces": f"src/repro/kernels/bsmm.py:{line}",
             "launches": t_launches[f"bsmm_{kind}"],
             **train_summary["bsmm_routes"].get(f"bsmm_{kind}", {}),
             "launches_lm_session": lm_launches[f"bsmm_{kind}"],
             **new_path_launches(f"bsmm_{kind}"),
             "max_abs_err": grad_err[f"bsmm_{kind}"],
             "ms": grad_row[f"{kind}_ms"],
             "plain_ms": grad_row[f"{kind}_plain_ms"],
             "bound_ms": grad_row[f"{kind}_bound_ms"],
             "bound_by": grad_row[f"{kind}_bound_by"],
             "library_ms": grad_row[f"{kind}_library_ms"]})
    kernels += [
        {"name": "bsmm_batched", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bsmm.cu",
         "replaces": "src/repro/kernels/bsmm.py:118",
         "launches": ds_launches["bsmm_batched"],
         **ds_summary["bsmm_batched_routes"],
         "launches_serve_llama4": l4_launches["bsmm_batched"],
         "routes_serve_llama4": l4_summary["bsmm_routes"]["bsmm_batched"],
         # llama4's up/gate over its 64 experts at each serving capacity
         "llama4": [{k: r[k] for k in ("E", "M", "K", "N", "route", "ms",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")}
                    for r in l4_batched_times if r["N"] == 8192],
         "max_abs_err": batched_err,
         "ms": batched_row["ms"], "plain_ms": batched_row["plain_ms"],
         "bound_ms": batched_row["bound_ms"],
         "bound_by": batched_row["bound_by"],
         "library_ms": batched_row["library_ms"],
         # at training rows (C = 320, E = 32, the up/gate shape): the
         # deepseek retrain's forward, launches from that run
         "training_rows": {
             "M": bgrad_row["M"], "E": bgrad_row["E"],
             "launches": rd_launches["bsmm_batched"],
             **rd_summary["bsmm_routes"]["bsmm_batched"],
             "ms": bgrad_row["fwd_ms"], "plain_ms": bgrad_row["fwd_plain_ms"],
             "bound_ms": bgrad_row["fwd_bound_ms"],
             "bound_by": bgrad_row["fwd_bound_by"],
             "library_ms": bgrad_row["fwd_library_ms"]}},
        {"name": "paged_attention_fused_v", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:133",
         "launches": ds_launches["paged_attention_fused_v"],
         "launches_by_route": ds_summary["fused_launches_by_route"],
         "max_abs_err": mla_err, "ms": mla_row["ms"],
         "plain_ms": mla_row["plain_ms"], "bound_ms": mla_row["bound_ms"],
         "bound_by": mla_row["bound_by"],
         "library_ms": mla_row["library_ms"]},
    ]
    # the expert-batched backward at the up/gate shape, C = 320, bf16;
    # launches from the deepseek retrain
    for kind, line in (("dx", 322), ("dw", 399)):
        name = f"bsmm_batched_{kind}"
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/bsmm.cu",
             "replaces": f"src/repro/kernels/bsmm.py:{line}",
             "launches": rd_launches[name], **rd_summary["bsmm_routes"][name],
             "max_abs_err": bgrad_err[name], "ms": bgrad_row[f"{kind}_ms"],
             "plain_ms": bgrad_row[f"{kind}_plain_ms"],
             "bound_ms": bgrad_row[f"{kind}_bound_ms"],
             "bound_by": bgrad_row[f"{kind}_bound_by"],
             "library_ms": bgrad_row[f"{kind}_library_ms"]})
    # the LTP baseline at decode rows with its own (iid) mask, the LTP
    # MLP's up and gate shape; tile stats at the size of vgg11's largest
    # conv matrices
    masked_row = next(r for r in masked_times if r["M"] == 8
                      and r["dtype"] == "bfloat16"
                      and r["mask"] == "ltp_iid_10pct")
    stats_row = stats_times[0]
    kernels += [
        {"name": "masked_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/masked_matmul.cu",
         "replaces": "src/repro/kernels/bsmm.py:617",
         "launches": cnn_launches["masked_matmul"] + ltp_summary["launches"],
         "launches_by_path": {"llama_ltp_mlp": ltp_summary["launches"],
                              "cnn": cnn_launches["masked_matmul"]},
         "launches_by_route": {
             k: v + cnn_summary["masked_matmul_launches_by_route"][k]
             for k, v in ltp_summary["launches_by_route"].items()},
         "split_launches": ltp_summary["split_launches"]
         + cnn_summary["masked_matmul_split_launches"],
         "max_abs_err": masked_err, "ms": masked_row["ms"],
         "plain_ms": masked_row["plain_ms"],
         "bound_ms": masked_row["bound_ms"],
         "bound_by": masked_row["bound_by"],
         "library_ms": masked_row["library_ms"]},
        {"name": "tile_stats", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/tile_stats.cu",
         "replaces": "src/repro/kernels/tile_stats.py:41",
         "launches": cnn_launches["tile_stats"],
         "max_abs_err": stats_err, "ms": stats_row["ms"],
         "plain_ms": stats_row["plain_ms"], "bound_ms": stats_row["bound_ms"],
         "bound_by": stats_row["bound_by"], "library_ms": None},
    ]
    # llama3.2-3b's prefill at a 512-token bucket, causal, bf16; and
    # recurrentgemma-2b's full window at hd = dv = 256 on the new
    # <4,4,64> instantiation (bf16) and on the f32 route at 300
    flash_row = next(r for r in flash_times if r["S"] == 512 and r["causal"]
                     and r["Hq"] == 24 and r["dtype"] == "bfloat16")
    hd256 = {}
    for r in flash_times:
        if r["hd"] == 256 and (r["S"], r["dtype"]) in (
                (2048, "bfloat16"), (300, "float32")):
            hd256[f"S={r['S']},{r['dtype']}"] = {
                k: r[k] for k in ("route", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms", "max_abs_err")}
    hd256["wgmma_ptxas"] = flash_build["ptxas"].get("<4,4,64>",
                                                    "not rebuilt")
    hd256["launches_serve_hybrid"] = hy_launches["flash_attention"]
    # whisper-tiny's widths (hd 64: the encoder over 1500 frames, full,
    # and a decoder prompt) and phi-3-vision's (hd 96, bf16 and f32)
    narrow = {}
    for r in flash_times:
        if r["hd"] in (64, 96):
            narrow[f"hd={r['hd']},S={r['S']},causal={r['causal']},"
                   f"{r['dtype']}"] = {
                k: r[k] for k in ("Hq", "Hkv", "route", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms",
                                  "max_abs_err")}
    narrow["launches_serve_whisper"] = wh_launches["flash_attention"]
    narrow["launches_serve_vlm"] = vl_launches["flash_attention"]
    narrow["launches_serve_llama4"] = l4_launches["flash_attention"]
    # the launch phase's PREFILL_32K shapes (llama3.2-3b, causal, bf16)
    long_rows = {
        f"S={r['S']}": {k: r[k] for k in ("route", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms", "max_abs_err")}
        for r in flash_times if r["S"] > FLASH_SDPA_GQA_MAX_S}
    kernels.append(
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:68",
         "launches": cp_launches["flash_attention"],
         "launches_serve_command_r": cr_launches["flash_attention"],
         "hd256": hd256, "hd64_hd96": narrow, "prefill_32k": long_rows,
         "max_abs_err": flash_err, "ms": flash_row["ms"],
         "plain_ms": flash_row["plain_ms"], "bound_ms": flash_row["bound_ms"],
         "bound_by": flash_row["bound_by"],
         "library_ms": flash_row["library_ms"]})
    # the distribution legs' launches: (a) one rank, (b) each of two
    # ranks on (1, 2) and (2, 1), #1b's (c) grouped MoE and (d) experts
    for k in kernels:
        if k["name"] in dist_launches:
            k["launches_distributed"] = dist_launches[k["name"]]
    # ... and the kernels held to their plain versions at every shape
    # leg (b) gave them on a rank, timed there (#1/#2 at 8 decode rows)
    dk = dist_summary["kernel_checks"]
    timed_keys = ("route", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms", "max_abs_err")
    for k in kernels:
        name = k["name"]
        if name in ("bsmm", "bsmm_epilogue"):
            ms, plain = (("bsmm_ms", "plain_ms") if name == "bsmm" else
                         ("bsmm_epilogue_ms", "epilogue_plain_ms"))
            local = {"max_abs_err": dk["bsmm_err"][name],
                     "rows_by_weight": dk["bsmm_rows"],
                     "m8": [{"K": r["K"], "N": r["N"], "route": r["route"],
                             "ms": r[ms], "plain_ms": r[plain],
                             "bound_ms": r["bound_ms"],
                             "bound_by": r["bound_by"],
                             "library_ms": (r["matmul_ms"] if name == "bsmm"
                                            else None)}
                            for r in dk["bsmm_times"]]}
            err = dk["bsmm_err"][name]
        elif name in ("bsmm_dx", "bsmm_dw"):
            local = {"max_abs_err": dk["grad_err"][name],
                     "rows_by_weight": dk["grad_rows"]}
            err = dk["grad_err"][name]
        elif name == "flash_attention":
            local = {"max_abs_err": dk["flash_err"], "shapes": [
                {"S": r["S"], "Hq": r["Hq"], "Hkv": r["Hkv"],
                 **{f: r[f] for f in timed_keys}} for r in dk["flash"]]}
            err = dk["flash_err"]
        elif name == "paged_attention":
            local = {"max_abs_err": dk["paged_err"], "shapes": [
                {"Hq": r["Hq"], "Hkv": r["Hkv"], "hd": r["hd"],
                 **{f: r[f] for f in timed_keys if f in r}}
                for r in dk["paged"]]}
            err = dk["paged_err"]
        else:
            continue
        k["distributed_shapes"] = local
        k["max_abs_err"] = max(k["max_abs_err"], err)
    # leg (g)'s launches on each rank (#7 under paged_attention_fused_v)
    # and its kernels held at the ranks' shapes
    fk = fam_summary["kernel_checks"]
    fam_errs = {"bsmm": fk["bsmm_err"]["bsmm"],
                "bsmm_epilogue": fk["bsmm_err"]["bsmm_epilogue"],
                "bsmm_dx": fk["grad_err"]["bsmm_dx"],
                "bsmm_dw": fk["grad_err"]["bsmm_dw"],
                "flash_attention": fk["flash_err"],
                "paged_attention_fused_v": fk["fused_err"],
                **fk["batched_err"]}
    for k in kernels:
        name = k["name"]
        key = ("paged_attention" if name == "paged_attention_fused_v"
               else None if name == "paged_attention" else name)
        if key in fam_launches:
            k["launches_families"] = fam_launches[key]
        if name in fam_errs:
            k["families_max_abs_err"] = fam_errs[name]
            k["max_abs_err"] = max(k["max_abs_err"], fam_errs[name])
    # the entry points' legs: (a) pruned serving, (b) the dense fleet,
    # (c) training, (d) the build_step cells
    for k in kernels:
        if k["name"] in launch_launches:
            k["launches_launch"] = launch_launches[k["name"]]
    # the lint path: every kernel's launches in legs (b) and (c), and the
    # default cases held to it in leg (a)
    for k in kernels:
        k["launches_lint"] = lint_launches[k["name"]]
        k["lint_cases"] = {
            n: {f: r[f] for f in ("route", "splits", "max_abs_err", "smem")}
            for n, r in lint_summary["cases"].items()
            if LINT_KERNEL_NAMES[r["kernel"]] == k["name"]}
    (OUT / "chip_smoke_kernels.json").write_text(json.dumps(
        {"device": smi, "bsmm": bsmm_times, "paged_attention": paged_row,
         "bsmm_grads": grad_times, "paged_attention_fused_v": mla_row,
         "bsmm_batched": batched_times + l4_batched_times,
         "bsmm_batched_grads": bgrad_times, "serve": summary,
         "grad_check": grad_summary, "retrain": train_summary,
         "serve_deepseek": ds_summary, "moe_grad_check": moe_grad_summary,
         "retrain_deepseek": rd_summary, "lm_session": lm_summary,
         "tile_stats": stats_times,
         "masked_matmul": masked_times, "ltp_mlp": ltp_summary,
         "masked_matmul_wgmma_smem": masked_smem,
         "bsmm_wgmma_smem": bsmm_smem, "cnn": cnn_summary,
         "flash_attention": flash_times, "flash_attention_build": flash_build,
         "control_plane": cp_summary, "serve_hybrid": hy_summary,
         "retrain_hybrid": rh_summary, "serve_command_r": cr_summary,
         "paged_attention_hd96": hd96_row, "serve_xlstm": xl_summary,
         "retrain_xlstm": rx_summary, "serve_whisper": wh_summary,
         "retrain_whisper": rw_summary, "serve_vlm": vl_summary,
         "retrain_vlm": rv_summary, "serve_llama4": l4_summary,
         "lint": lint_summary, "distributed": dist_summary,
         "distributed_g": fam_summary,
         "launch": launch_summary, "dryrun": dryrun_summary,
         "phase_s": phases},
        indent=1, default=str))
    print(json.dumps({"serve": {**summary, "decode_profile": {
        k: v for k, v in summary["decode_profile"].items()
        if k != "top_kernels"}}}, default=str))
    print(json.dumps({"control_plane": {k: v for k, v in cp_summary.items()
                                        if k != "prefill_profile"}},
                     default=str))
    print(json.dumps({"ltp_mlp": ltp_summary}))
    print(json.dumps({"grad_check": grad_summary}))
    print(json.dumps({"retrain": train_summary}, default=str))
    print(json.dumps({"lm_session": {k: v for k, v in lm_summary.items()
                                     if k != "cli"}}, default=str))
    print(json.dumps({"serve_deepseek": {k: v for k, v in ds_summary.items()
                                         if k != "report"}}, default=str))
    print(json.dumps({"moe_grad_check": moe_grad_summary}))
    print(json.dumps({"retrain_deepseek": {
        k: v for k, v in rd_summary.items() if k != "profile"}},
        default=str))
    print(json.dumps({"cnn": {k: v for k, v in cnn_summary.items()
                              if k != "losses"}}, default=str))
    for name, summ in (("serve_hybrid", hy_summary),
                       ("retrain_hybrid", rh_summary),
                       ("serve_command_r", cr_summary),
                       ("serve_xlstm", xl_summary),
                       ("retrain_xlstm", rx_summary),
                       ("serve_whisper", wh_summary),
                       ("retrain_whisper", rw_summary),
                       ("serve_vlm", vl_summary),
                       ("retrain_vlm", rv_summary),
                       ("serve_llama4", l4_summary)):
        print(json.dumps({name: {k: v for k, v in summ.items()
                                 if k not in ("report", "profile",
                                              "decode_profile")}},
                         default=str))
    print(json.dumps({"lint": {k: v for k, v in lint_summary.items()
                               if k != "cases"}}, default=str))
    print(json.dumps({"distributed": {
        "one_rank": dist_summary["one_rank"],
        "ranks": [{k: v for k, v in r.items() if k != "rank"}
                  for r in dist_summary["ranks"]],
        "kernel_checks": {k: v for k, v in
                          dist_summary["kernel_checks"].items()
                          if k.endswith("_err") or k.endswith("_rows")},
        "grouped_moe": dist_summary["grouped_moe"],
        "restart": dist_summary["restart"]}}, default=str))
    print(json.dumps({"distributed_g": {
        "ranks_s": fam_summary["ranks_s"],
        "ds_prefill_launches": fam_summary["ds_prefill_launches"],
        "ranks": [{k: v for k, v in r.items() if k != "batched_shapes"}
                  for r in fam_summary["ranks"]],
        "kernel_checks": {k: v for k, v in fam_summary["kernel_checks"]
                          .items() if k.endswith("_err")}}}, default=str))
    print(json.dumps({"launch": {
        k: ({kk: vv for kk, vv in v.items() if kk != "bsmm_routes"}
            if isinstance(v, dict) else v)
        for k, v in launch_summary.items()}}, default=str))
    print(json.dumps({"dryrun": dryrun_summary}, default=str))
    print(json.dumps({"phase_s": phases}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
