#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare-kernel1 DIR
    python3 chip_smoke.py --production-grid

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version (kernel #1 also, through
``kernels.ops.dft_apply``, against ``kernels.ref.dft_apply_ref``, an FFT of
the padded or truncated line) at the shapes of the stacked
plane-wave SCF at the paper's widths (grid n = 256, sphere diameter
d = 128: ``repro/configs/fftb_paper.py``) and, for the sphere kernels, at
small edge cases (ragged tiles, partial K chunks, odd n, every slab
layout, NaN-poisoned padded lanes, ``flag = 0`` planes), then runs that
SCF through the
public entry point ``repro_torch.dft.run_scf`` on the kernel route
(``backend="cuda"``) and on the plain ``torch.matmul`` route, and compares
the two.  Every kernel of the path must have launched during the kernel
route's run.

Three phases follow on the same SCF configuration:

* the executor modes at the SCF's stacked inverse plan (B = 32, d = 128
  → n = 256): eager, lazy fp32 and lazy bf16, each timed with CUDA
  events, its error against the eager result's largest value and its
  peak memory; then ``tune()`` of a copy of that plan;
* the SCF under ``ExecPolicy(mode="lazy")`` against the eager "cuda"
  run (the sphere kernels launch, kernel #1 does not);
* the fused step (``jit_step=True``), captured as CUDA graphs: once
  with linear mixing against an eager run with linear mixing, once with
  the Anderson mixer on the device; each prints its first and steady
  seconds per iteration, graphs, replays, the host syncs of one steady
  iteration (counted by the sync debug mode, and named), peak memory and
  one traced steady iteration by graph.  The launches inside the capture
  are counted once; the steady iterations must launch no wrapper and run
  no plan call.

Then the multi-rank phase: four processes spawned on the one card
(``repro_torch.sharding.procs.run_ranks``, gloo, a ``file://``
rendezvous under ``build/multirank/``; gloo carries each collective
through host memory, so the phase times what the ranks' local shapes
cost under that transport and gives no scaling number) run the SCF's
widths on the 2×2 batch×fft grid: one stacked H apply per rank against
the single-rank one (within 1e-5 of the largest value, padded lanes
exactly +0.0), one all-to-all timed, then the SCF for MR_ITERS
iterations from the same start against a single-rank eager "cuda" run
of as many (PERF.md §2's limits); kernels #1, #3 and #4 are counted
per rank, with the counts set to 0 in each rank just before its run.
In the same processes the fused step (``jit_step=True``, linear mixing)
runs that SCF on that grid: its
graphs and host syncs per iteration (by name), first and steady
seconds per iteration and peak memory per rank, held against the 2×2
eager run and against one rank's fused step.  Eight processes then run
the SCF of the reference's pencil case (n = 16, the (2, 2, 2) grid from
``choose_dft_grid``) to convergence, eager against one rank and fused
against the eager run.  A rank that fails, or a run past its time
limit, fails the script.

Two more paths follow, each with the launch counts set to 0 just before
it and read just after:

* the four-step DFT (``repro_torch.kernels.ops.four_step_dft``) on 4096
  lines of n = 4096, forward and inverse, against ``torch.fft``, after the
  twiddle kernel is held against its plain version (ragged, odd-K and
  NaN-poisoned cases and the four-step's stage-1 shape);
* the multi-tenant ``TransformService`` at n = 256 (d = 128 and d = 64
  spheres, four tenants, nine requests, one with an expired deadline),
  started with ``start()`` and warming asynchronously, the trace sent
  once cold, once to the warm service and once more with the tracer's
  sync on (the by-piece breakdown of each dispatch, read from the
  service's own spans); its dispatches run the fused sphere kernels;
  every result is held against ``eager_apply``, against the same trace
  through a ``backend="matmul"`` service, and the round trips against
  their input; the padded lanes of every packed block must be +0.0.
  Inside it the port's tracer records one ``eager_apply``: its per-stage
  spans must match the plan's stages and cover each stage's CUDA-event
  time.  Then the same trace through a service on the 2×2 grid of four
  processes over gloo (front end rank 0, the other ranks following it),
  every result held against the one-rank service's, padded lanes +0.0,
  p50/p99 latency and requests/s on the front end, kernels #1, #3, #4
  counted per rank.

Two more phases run the paper's own workload and the spectral layers:

* the paper phase: ``repro_torch.configs.fftb_paper.CONFIG`` (n = 256,
  d = 128, 256 bands), its grid from ``choose_dft_grid``, audited by
  ``preflight_basis(deep=True, backend="cuda")``, then the fused pair of
  ``make_planewave_pair`` on "cuda" (``unpack_transform``: kernel #3,
  then kernel #1 per stage; ``transform_pack``: kernel #1, then kernel
  #4) over every band, in batches of the largest of ``PAPER_BATCHES``
  bands whose peak memory, estimated from the plans' stage shapes before
  any launch, fits (printed beside the measured peak); every band's cube
  and forward are held to the "matmul" route and the round trip to its
  input, the launches per call are counted, and each call is timed
  beside its bound.  Then the full-cube baseline of the paper's Fig. 9:
  an inverse ``FftPlan`` over the whole (nb, n³) cube (kernel #1 only);
* the spectral phase: ``fourier_mixer`` on (8, 2048, 1024) and
  ``fft_conv`` at Mamba-2 370M's conv width (8, 1024, 2304), K = 4, on
  "cuda" (kernel #1 on lines of 1024 and 2048) against the "matmul" route
  and torch.fft.

Then the LM phase, the reference's LM serving path through the port's
``repro_torch.models`` and ``repro_torch.serve.engine.ServeEngine``
(no hand kernel: the reference's LM path reaches no Pallas kernel, so
every kernel's launches on it must be 0):

* ``granite-moe-3b-a800m`` and ``mamba2-370m`` at their published
  configs (bf16), random weights from a seeded generator on the card, 8
  requests (prompts of 64–512 tokens from a seeded draw, 32 new tokens
  each) through ``ServeEngine(slots=4, capacity=1024)``, a cold pass and
  a warm pass for Granite-MoE, one pass for Mamba-2: parameters against
  ``param_count()``, ms per prefill by prompt length, ms per decode step
  (p50, p99), generated tokens/s, peak memory, and one decode step under
  ``torch.profiler`` (aten ops, CUDA kernels, kernel time) beside the
  bound of reading every weight once; then the same weights in fp32
  (TF32 off, ``capacity_factor`` = ``n_experts`` so nothing drops):
  prefill 32 tokens and decode 32 for B = 2 against the teacher-forced
  forward's logits (1e-4 of the largest |logit|), the bf16 run's logits
  beside them (a report), and for Mamba-2 the forward with
  ``conv_impl="fft"`` against ``"direct"``;
* the other families reduced, fp32 on the card (dense, VLM with image
  embeddings, hybrid, encoder-decoder with frames): prefill and decode
  against teacher-forced, 1e-4.  Every tensor of every model and cache
  lies on the card.

Then the train phase, the reference's LM training path through the
port's ``repro_torch.train`` (no hand kernel either: every kernel's
launches over the phase must be 0; TF32 stays off):

* ``tinyllama-1.1b`` at its published config (bf16, remat "full") through
  ``Trainer``: 6 steps on one fixed batch of 8 x 1024 tokens in 2
  microbatches, a final blocking checkpoint (10.25 GiB: bf16 weights,
  f32 m and v) under ``build/``, then a second ``Trainer`` resuming at
  step 6 to step 8, and the restored weights served through
  ``ServeEngine`` (one request, 3 tokens): per-step ms, tokens/s, peak
  memory against the state's estimate, the checkpoint's bytes, write
  and restore seconds, the loss curve; the loss must fall from within
  1.0 of ln 32000;
* ``granite-moe-3b-a800m``'s train step at its published config, 3
  steps on a fixed batch: ms per step, peak memory; the loss must fall;
* the six families reduced, fp32, from the same weights on the card and
  on the CPU: the gradients of one step within 1e-5 of the largest, two
  compressed train steps (loss within 1e-5, the int8 codes equal but at
  rounding boundaries, grad_norm within 1e-4, parameters within 2·lr);
  TinyLlama at published width cut to 2 layers, fp32: the gradients
  under remat "full" and "dots" against "none" within 1e-5, with each
  mode's peak memory;
* ``python -m repro_torch.launch.train --preset 100m --steps 10
  --fixed-batch`` in a subprocess: its last loss below its first.

Then the sharded_train phase, the train path on placed weights
(``repro_torch.sharding.rules.place_params``: each rank keeps its block of
every parameter and of the AdamW moments, FSDP over "data" and tensor
parallelism over "model"; no hand kernel: every kernel's launches over
the phase must be 0).  Four processes share the card over gloo on the
2×2 ("data", "model") grid (``run_ranks``; gloo stages each collective
through host memory, so no scaling number):

* ``tinyllama-1.1b`` at its published widths cut to 4 layers through
  ``Trainer``, the train phase's batch of 8 x 1024 tokens in 2
  microbatches, SHARD_STEPS steps: per rank the parameter and AdamW
  state bytes, which must equal ``launch/dryrun.py::state_bytes`` on
  the abstract 2×2 grid to the byte, the peak memory, ms per steady
  step and the operand bytes of each collective kind per step
  (``core/grid.py::COLLECTIVE_BYTES``) beside ``model_collectives``'
  prediction; the first step's loss and
  grad_norm against one process's step from the same weights and batch
  (run first, in this process); the Trainer's final checkpoint (whole
  tensors, gathered to the writer) restored into each rank's blocks,
  bitwise equal to what it saved;
* float32 at published width cut to 2 layers, 2 steps: loss, grad_norm
  and the first step's gradient within 1e-5 relative and the gathered
  parameters within 1e-3 of their largest, against one process (which
  also runs twice, to show how far it is from itself).

Then the ep_train phase, expert parallelism on placed weights (each
model rank keeps 20 of Granite-MoE's 40 experts, FSDP over "data";
every kernel's launches over the phase must be 0): ``granite-moe-3b-
a800m`` at its published widths cut to 4 layers through ``Trainer`` on
the same 2×2 grid, batch and microbatches, EP_STEPS steps, with no
checkpoint; per rank the state bytes against ``state_bytes`` to the
byte, the peak, ms per steady step and the counted collective bytes
per kind, which must equal ``ep_counted_bytes`` (PERF.md §5's
arithmetic) and are printed beside ``model_collectives``; the first
step against one process routed per batch row (run first and freed
before the ranks start), and the float32 2-layer run held as the
sharded_train phase's.

Then the tp_train phase, tensor parallelism over "model" for the SSM,
RG-LRU and encoder-decoder families on the same 2×2 grid, batch and
microbatches (FSDP over "data"; every kernel's launches over the phase
must be 0): ``mamba2-370m`` at its published widths cut to
MAMBA_LAYERS layers (its final checkpoint restored into blocks,
bitwise; its bf16 limit derived from depth), ``recurrentgemma-9b`` at
published widths cut to one (rec, rec, attn) period and
``whisper-small`` cut to 1 encoder and 1 decoder layer (2 + 2 until the
tp_uneven phase came: the script's time), each through ``Trainer`` for
TP_STEPS steps in one spawn of four ranks: per rank the state bytes
against ``state_bytes`` to the byte, the peak, ms per steady step and
the counted collective bytes per kind, which must equal
``tp_counted_bytes`` (PERF.md §5's arithmetic) and are printed beside
``model_collectives``; the first step against one process (run first,
and freed, in this process), and a float32 cut run (TP_MODELS) held as
the sharded_train phase's.

Then the tp_uneven phase, tensor parallelism over a "model" axis that
does not split the heads evenly (rank r of M computes heads [r·H // M,
(r+1)·H // M), the attention weights taken whole over "model" and
sliced; every kernel's launches over the phase must be 0):
``whisper-small`` at its published widths (12 heads) cut to 1 encoder
and 1 decoder layer on the (1, 8) ("data", "model") grid, eight
processes sharing the card over gloo, run as the tp_train phase (no
checkpoint): state bytes against ``state_bytes`` on the abstract (1, 8)
grid, counted collective bytes against ``tp_counted_bytes`` (whose
``attn_whole`` adds the weights taken whole), the model ranks'
head ranges covering every head once, the bf16 first step against one
process within UNEVEN_BF16_RTOL and the float32 run's loss and grad_norm
within UNEVEN_EXACT_RTOL.

With ``--production-grid`` the script runs only the tp_production
phase, the tp_uneven phase on the reference's 16-way "model" axis, the
(1, 16) grid, sixteen processes: ``granite-moe-3b-a800m`` at its
published widths cut to 1 layer, where 16 divides none of its 24 heads,
8 KV heads, 40 experts and 49155 rows (each rank computes 1 or 2 heads,
query head h reads KV head h // 3, all 40 experts whole on every rank
route in one global group; counted bytes against ``ep_counted_bytes``;
its float32 run replays one process's routing), and ``whisper-small``
as in tp_uneven, four of whose ranks compute no heads.

Then the dryrun phase, the port's dry run (``repro_torch.launch.
dryrun``: an accounting on the ``meta`` device over abstract grids, no
card and no process group): the paper's cell in both variants on the
16×16 and 2×16×16 grids, ``lower_cell`` of tinyllama-1.1b × train_4k and
granite-moe-3b-a800m × decode_32k on 16×16, and one calibration cell:
the accounting of the train phase's own TinyLlama step (8 × 1024 tokens
in 2 microbatches, remat "full", float32 m and v, a 1×1 grid), whose
state bytes (parameters, m, v and the step; gradients; the float32
accumulator) must equal, to the byte, what the train phase's profiled
step held on the card; its FLOPs, bytes and peak are printed beside the
measured step time, kernel time and peak, with the achieved TFLOP/s and
``bytes_accessed`` / 3.35 TB/s.  Then the examples phase: the six
``examples/torch_*.py`` through their ``main()`` at their defaults on the
card (``torch_train_lm`` at 20 steps, the fewest its loss check allows),
each passing its own assertions, with every kernel wrapper's count set to
0 just before and read just after (the examples run the "matmul" route:
0 launches), within 120 s.

Last, kernel #1 is timed at every distinct line shape that the SCF, the
four-step, the service and the spectral paths launched (recorded while
each path ran), beside its two bounds,
complex64 ``torch.matmul`` on the same lines, its call-C time and the
``movedim``/``reshape`` copy that the "cuda" backend makes of a stage's
input whose axis is not the last.

Exits non-zero, printing no result line, on any failed check or when no
CUDA device is present.

With ``--compare-kernel1 DIR`` it only times kernel #1 of this tree
against kernel #1 built from the sources of the checkout at DIR (say, a
``git archive`` of the parent commit unpacked under ``build/``), in
alternating pairs at every line shape of PERF.md's call-C table.

Printed, in order: the card's name and power limit, the kernel build time
and each kernel's ``-Xptxas -v`` summary (registers, spills), per-kernel
errors/exact-zero checks/times with two bounds each (fp32 FMA, and
3xTF32 on the tensor cores; the sphere kernels also beside their SIMT
times of PERF.md's call C, with the K chunks and tiles ``unpack_dft``
skips and the time of ``dft_pack``'s zero-tail kernel), the SCF
comparison and its breakdown, the layout of the slab the fused pack gets
on the SCF path under each executor (read in place, or copied), the
executor-mode, lazy-SCF and fused-step phases, the multi-rank phase
(per rank: coordinate, H apply and all-to-all ms, first and steady
s/iteration, peak memory and launches, each tagged "4 processes on one
card, gloo"; the checks against one rank; the fused step's graphs,
host syncs and times per rank and its checks; the pencil runs), the
four-step phase (kernel #2's and the composition's times beside
``torch.fft``'s), the service phase (each pass's metrics summary beside
the card's name and power limit, its batches, the warm pass's dispatch
spans and the synced pass's dispatches by piece; then the multi-rank
service's passes, dispatches by piece and launches per rank), the paper
phase (grid,
preflight, memory estimate and measured peak, batch, agreement, launches
per call, times and bounds, the full-cube baseline), the spectral phase,
the LM phase (per served model and pass: prefill and decode times,
tokens/s, peak memory, the card's name and power limit; the decode
step's launches and bound; the agreements), the train phase (step
times, losses, peaks, checkpoint, agreements, launcher), the
sharded_train phase (per rank: state bytes against the accounting, peak,
step times, losses, checkpoint seconds; the counted collective bytes
beside the model; the agreements), the ep_train phase (the same for the
MoE, without a checkpoint), the dryrun
phase (the cells' records, the calibration beside the measured step),
the examples phase (each example's numbers and wall time, the launches),
the per-shape table of kernel #1, one JSON line ``{"kernels": [...]}``
(each kernel's launches on the main path, the smoke SCF, by path and
per rank on each multi-rank path),
and last the device JSON line.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
#: where the multi-rank phase keeps its inputs and rendezvous files
#: (ignored by git)
MR_DIR = os.path.join(HERE, "build", "multirank")

# the slice's configuration: the paper's transform widths, cut in scale only
N, DIAMETER = 256, 128
KPTS = ((0.0, 0.0, 0.0), (0.5, 0.5, 0.5))
NBANDS, MAX_ITER, SEED = 16, 3, 0
REDUCED = {"nbands": "256 -> 16 per k-point", "scf_iterations": "~40 -> 3"}

# the four-step phase: B lines of a composite n = n1·n2 (n1 = n2 = 64)
FOUR_STEP_LINES, FOUR_STEP_N = 4096, 4096
# the service phase: the paper's cube and cutoff plus a smaller cutoff
# (another compatibility class); tenants, requests, bands, sphere, potential
SERVICE_N, SERVICE_D, SERVICE_D_SMALL, SERVICE_MAX_ROWS = 256, 128, 64, 16
SERVICE_TRACE = (
    # tenant, requests, bands, k-point, diameter, potential, deadline
    ("alpha", 2, 4, (0.0, 0.0, 0.0), "d", True, None),
    ("beta", 2, 4, (0.5, 0.5, 0.5), "d", True, None),
    ("gamma", 2, 2, (0.0, 0.0, 0.0), "d", False, None),
    ("delta", 2, 4, (0.0, 0.0, 0.0), "d_small", True, None),
    ("alpha", 1, 1, (0.0, 0.0, 0.0), "d", True, 0.0),
)
# the piece spans of every dispatch (TransformService._dispatch)
SERVICE_PIECES = {"upload_coeffs_ms", "unpack_transform_ms",
                  "transform_pack_ms", "download_ms"}
# a traced stage's host-clock span against its CUDA-event time: the span
# is synchronized at exit, so it covers the device work (and more)
SPAN_COVERAGE = 0.9
# the paper phase: the paper's own workload at full width
# (repro_torch/configs/fftb_paper.py: n = 256, d = 128, 256 bands) in band
# batches, the largest of PAPER_BATCHES whose memory estimate stays within
# PAPER_MEM_SHARE of the free device memory (the rest is for the caching
# allocator's split blocks and the libraries' workspaces); the "matmul"
# route that the kernels' route is held to runs PAPER_CHECK_BANDS bands a
# call; both routes fp32, sums in another order: PAIR_RTOL of the largest
# value
PAPER_BATCHES = (256, 128, 64)
PAPER_MEM_SHARE = 0.9
PAPER_CHECK_BANDS = 8
PAIR_RTOL = 1e-5
# the spectral phase: fourier_mixer on (B, S, D) float32 (kernel #1 on
# lines of 1024 and 2048), fft_conv at Mamba-2 370M's conv width (d_inner
# 2048 + 2 * ssm_state 128 channels, kernel 4: src/repro/configs/
# mamba2_370m.py, src/repro/models/ssm.py:29), S = 1024 padded to L = 2048
MIXER_SHAPE = (8, 2048, 1024)
CONV_SHAPE, CONV_K = (8, 1024, 2304), 4
# the LM phase: two models served at their published configs (bf16,
# random weights from a seeded generator on the card) through ServeEngine;
# prompts drawn in LM_PROMPT, LM_NEW tokens each; then the same weights
# in fp32 (TF32 off, nothing dropped by the MoE) prefill LM_AGREE_PREFIX
# tokens and decode as many against the teacher-forced forward: fp32 sums
# in another order, LM_RTOL of the largest |logit|.  The other families
# run reduced, fp32, held to the same limit.  conv_impl="fft" vs "direct"
# at Mamba-2's full width: the reference's own test tolerance
# (tests/test_models.py, rtol = atol = 2e-3); parameter count vs the
# analytic count within the reference test's 5%
# model, passes: Granite-MoE cold and warm; Mamba-2 once, in a process the
# first model has warmed (its odd prompt lengths prefill in 1-token chunks)
LM_SERVED = (("granite-moe-3b-a800m", ("cold", "warm")),
             ("mamba2-370m", ("first",)))
LM_REDUCED = ("tinyllama-1.1b", "pixtral-12b", "recurrentgemma-9b",
              "whisper-small")
LM_REQUESTS, LM_SLOTS, LM_CAPACITY, LM_NEW = 8, 4, 1024, 32
LM_PROMPT = (64, 512)
LM_AGREE_B, LM_AGREE_PREFIX = 2, 32
LM_RTOL = 1e-4
LM_FFT_TOL = 2e-3
LM_PARAM_RTOL = 0.05
# the train phase: TinyLlama-1.1B at its published config (bf16, remat
# "full") through Trainer on a fixed batch of TRAIN_BATCH x TRAIN_SEQ
# tokens in TRAIN_MB microbatches, TRAIN_STEPS steps, a final blocking
# checkpoint, then a second Trainer resuming to TRAIN_RESUME_STEPS and the
# restored weights served (TRAIN_NEW tokens); Granite-MoE 3B-A800M's train
# step at its published config for TRAIN_MOE_STEPS steps; the six families
# reduced (fp32) on the card against the port's CPU route, two steps with
# compression: float32 sums in another order, TRAIN_RTOL relative (loss,
# grad_norm) and of the largest gradient; the launcher's 100m preset
TRAIN_ARCH, TRAIN_MOE = "tinyllama-1.1b", "granite-moe-3b-a800m"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MB = 1024, 8, 2
TRAIN_STEPS, TRAIN_RESUME_STEPS, TRAIN_MOE_STEPS, TRAIN_NEW = 6, 8, 3, 3
TRAIN_LR, TRAIN_AGREE_LR = 3e-4, 1e-4
TRAIN_FAMILIES = ("tinyllama-1.1b", "granite-moe-3b-a800m", "pixtral-12b",
                  "mamba2-370m", "recurrentgemma-9b", "whisper-small")
TRAIN_RTOL = 1e-5
# compressed steps: an element whose int8 code sits at a rounding boundary
# may round the other way on the card (its gradient differs by ~1e-6);
# such a flip moves the element's gradient by a whole quantisation step
# and its update by up to lr, so grad_norm is held to TRAIN_COMP_RTOL
# (measured up to 1.1e-5 on an NVIDIA H100 80GB HBM3 at 700 W) and at
# most TRAIN_FLIP_SHARE of the codes and parameters may differ that way
TRAIN_COMP_RTOL, TRAIN_FLIP_SHARE = 1e-4, 1e-3
TRAIN_REMAT_LAYERS, TRAIN_REMAT_B = 2, 2
TRAIN_LAUNCHER_STEPS = 10
#: free disk the TinyLlama checkpoint needs: bf16 params, f32 m and v
TRAIN_CKPT_GIB = 10.25

# the sharded_train phase: the train path on placed weights (FSDP over
# "data" x tensor parallelism over "model", sharding/rules.py::
# place_params), SHARD_PROCS processes sharing the card over gloo on the
# SHARD_GRID grid.  TinyLlama-1.1B at its published widths cut to
# SHARD_LAYERS of its 22 layers (a cut of depth that keeps the script
# within its time since the tp_train phase came) through Trainer (the
# train phase's batch, microbatches and learning rate, SHARD_STEPS
# steps, 3 until Granite-MoE's (1, 16) run came (see TP_STEPS), its
# final checkpoint restored into blocks); the
# first step's loss and grad_norm against one process's step from the
# same weights and batch within SHARD_LOSS_RTOL / SHARD_GNORM_RTOL (bf16:
# each row-parallel output rounds to bf16 once more; measured 5.75e-6
# and 2.78e-4 on an NVIDIA H100 80GB HBM3 at 700 W, the same in two
# calls); then float32 at published width cut to SHARD_EXACT_LAYERS
# layers, SHARD_EXACT_STEPS steps at TRAIN_AGREE_LR: loss, grad_norm and
# the first step's gradient (its first moment, of its largest) within
# SHARD_EXACT_RTOL (measured 8.8e-8, 9.7e-8 and 4.6e-6), the gathered
# parameters within SHARD_EXACT_PARAM of their largest: Adam divides each
# gradient element by its own RMS, so an element whose gradient lies
# within its float32 rounding of zero moves by up to the learning rate
# either way (measured 2.85e-4, in the embedding; one process against
# itself: 0)
SHARD_PROCS, SHARD_GRID, SHARD_AXES = 4, (2, 2), ("data", "model")
SHARD_LAYERS = 4
SHARD_STEPS, SHARD_EXACT_LAYERS, SHARD_EXACT_STEPS = 2, 2, 2
SHARD_LOSS_RTOL, SHARD_GNORM_RTOL = 2e-5, 1e-3
SHARD_EXACT_RTOL, SHARD_EXACT_PARAM = 1e-5, 1e-3
SHARD_TIMEOUT, SHARD_THREADS = 900.0, 2
SHARD_DIR = os.path.join(HERE, "build", "sharded")
SHARD_TAG = "4 processes on one card, gloo"
#: a rehearsal on the CPU trains the reduced config (the job carries it)
SHARD_REDUCED = False

# the ep_train phase: expert parallelism (sharding/rules.py::place_params
# keeps E/M experts per "model" rank, FSDP over "data"), EP_PROCS
# processes sharing the card over gloo on the EP_GRID grid.  Granite-MoE
# 3B-A800M at its published widths cut to EP_LAYERS of its 32 layers (a
# cut of depth that keeps the script within its time since the tp_train
# phase came) through Trainer (the train phase's batch, microbatches and
# learning rate, EP_STEPS steps, 3 until Granite-MoE's (1, 16) run came
# (see TP_STEPS), no checkpoint);
# the first step's loss and grad_norm against one process's step from the
# same weights and batch, routed per batch row as on the grid, within
# EP_LOSS_RTOL / EP_GNORM_RTOL (bf16: each row-parallel sum rounds once
# more, and tokens near a routing tie may take another expert; measured
# 2.09e-5 / 9.19e-4 and 2.61e-5 / 4.48e-4 in two calls on an NVIDIA H100
# 80GB HBM3 at 700 W); then float32 at published width
# cut to EP_EXACT_LAYERS layers, EP_EXACT_STEPS steps, held as the
# sharded_train phase's (SHARD_EXACT_RTOL, SHARD_EXACT_PARAM), the placed
# run replaying one process's routing (RouteTape): a token whose K-th and
# (K+1)-th logits differ by float32 rounding may pick another expert in
# each run, and one such token moved the first step's gradient by 8.06e-4
# of its largest (measured on an NVIDIA H100 80GB HBM3 at 700 W); every
# row that routes otherwise must lie within EP_TIE of a tie
EP_PROCS, EP_GRID, EP_AXES = 4, (2, 2), ("data", "model")
EP_LAYERS = 4
EP_STEPS, EP_EXACT_LAYERS, EP_EXACT_STEPS = 2, 2, 2
EP_LOSS_RTOL, EP_GNORM_RTOL = 8e-5, 3e-3
EP_TIE = 1e-5
EP_TIMEOUT = 900.0
EP_DIR = os.path.join(HERE, "build", "ep")
#: a rehearsal on the CPU trains the reduced config (the job carries it)
EP_REDUCED = False

# the tp_train phase: tensor parallelism over "model" for the SSM, RG-LRU
# and encoder-decoder families (sharding/rules.py::place_params, FSDP over
# "data"), one process a point of the TP_GRID grid sharing the card over
# gloo, through Trainer with the train phase's batch, microbatches and
# learning rate, TP_STEPS steps (3 before Granite-MoE's (1, 16) run came:
# the second step is the first with moments and a checkpoint to
# restore, a third runs no other code, and one steady step of each of
# the two phases' five models cost ~47 s of the script's time).
# TP_MODELS: each model's cut of its
# published config for that run and for the float32 run (TP_EXACT_STEPS
# steps at TRAIN_AGREE_LR), held as the sharded_train phase's
# (SHARD_EXACT_RTOL, SHARD_EXACT_PARAM).  Mamba-2 370M is cut to
# MAMBA_LAYERS of its 48 layers, its checkpoint with it, a cut of depth
# that pays for the tp_uneven phase's Granite-MoE run, and that its
# bf16 limit, derived from depth (MAMBA_BF16_*), allows;
# RecurrentGemma-9B is cut to one (rec, rec, attn) period (its
# 38 layers' bf16 weights, float32 moments and accumulator, ~126 GB
# across the four ranks, do not fit one 80 GB card), and its float32 run
# to a vocabulary of 32000 (the four ranks' float32 state and gathered
# embedding and head at 256000, ~92 GB, do not fit either);
# Whisper-small is cut to 1 encoder and 1 decoder layer (its 1500-frame
# attention runs 375 key blocks in Python, on four ranks sharing one
# card), a cut of depth that keeps the script within its time since the
# tp_uneven phase came (2 + 2 layers before).  The first bf16 step's
# loss and grad_norm against one process's, within TP_BF16_RTOL: for
# RecurrentGemma and Whisper ~3x the measured on an NVIDIA H100 80GB
# HBM3 at 700 W (Whisper at 2 + 2 layers: loss 7.26e-6 and 4.94e-6,
# grad_norm 1.26e-4 and 6.06e-4: each row-parallel sum and the gathered
# activations round to bf16 once more); for Mamba-2 from its error
# model.
# Mamba-2's error model (tools/tp_bf16_depth.py; PERF.md §6): the
# placed step rounds each layer's row-parallel out_proj sum, and the
# activations around it, to bf16 once more than one process does; to
# first order the loss (grad_norm) responds to each such rounding
# linearly, with signs that change from one weight draw to the next, so
# the relative error of the first step is normal with mean 0 and a
# deviation that grows with the number of layers whose roundings add
# up, each weighted by how much the loss responds to it there (the
# responses grow with depth at initialisation: the one-process grad_norm
# is 2.2, 3.8, 7.4 and 22.7 at 4, 8, 16 and 48 layers), σ(L) = s·L^α.
# The same law holds in both packages at reduced width on the CPU (100
# draws, 2-48 layers: loss α 1.18 in the port, 1.33 in the reference,
# 1.24 together; no fault: the port's spread is the reference's); at
# published width on the card (19 draws: seeds 0-2 at 4, 8, 16 and 48
# layers and seeds 3-9 at 4, NVIDIA H100 80GB HBM3 at 700 W,
# `tools/tp_bf16_depth.py --card`) the maximum-likelihood fit is
# MAMBA_BF16_MODEL.  The limit at L layers is MAMBA_BF16_Z times the 95%
# upper bound of σ(L) from those MAMBA_BF16_DRAWS draws (1.37σ), one z
# for both kinds: the card's draws are normal (the largest at 1.9σ), and
# z = 3.29 is the two-sided normal quantile of 1e-3, so a sound step
# fails either kind with a chance of 2e-3 at most while σ lies under its
# bound, 1.3e-5 at the fit.  At 4 layers the limit is 4.0e-5 (loss) and
# 3.2e-3 (grad_norm), 4.5σ(4), 2.4 and 3.0 times the largest of the 10
# draws there.  Its cost (`tools/tp_bf16_depth.py --fit`): a fault that
# multiplies the placed step's extra rounding error k-fold fails it
# with a chance of 0.13 at k = 3, 0.37 at k = 5 and 0.65 at k = 10 (even
# chances at k = 6.7): one draw a run tells a fault from luck only when
# the fault is several-fold.  The limit this replaces, 2.5e-5 / 2.5e-2
# at 48 layers, was ~3x one draw (seed 0's 7.18e-6): seeds 1 and 2
# measure 6.13e-5 and 7.60e-5 there, and the 5.49e-5 met at 16 layers is
# seed 0's draw at that depth, 1.7σ
MAMBA_LAYERS = 4
MAMBA_BF16_MODEL = {"loss": (2.533e-6, 0.91), "grad_norm": (1.764e-4, 1.00)}
MAMBA_BF16_DRAWS = 19
MAMBA_BF16_Z = 3.29


def sigma_upper(s: float, n: int) -> float:
    """The 95% upper confidence bound of a normal deviation estimated as
    ``s`` from ``n`` draws: s·sqrt(n / χ²_n(0.05)) (Wilson-Hilferty's
    quantile)."""
    q = n * (1 - 2 / (9 * n) - 1.6449 * math.sqrt(2 / (9 * n))) ** 3
    return s * math.sqrt(n / q)


def mamba_bf16_limit(kind: str, layers: int) -> float:
    """Mamba-2's bf16 limit for ``kind`` ("loss", "grad_norm") at
    ``layers`` layers: MAMBA_BF16_Z times the upper bound of σ(L)."""
    s, a = MAMBA_BF16_MODEL[kind]
    return MAMBA_BF16_Z * sigma_upper(s, MAMBA_BF16_DRAWS) * layers ** a


TP_GRID, TP_AXES = (2, 2), ("data", "model")
TP_STEPS, TP_EXACT_STEPS = 2, 2
TP_MODELS = {"mamba2-370m": ({"n_layers": MAMBA_LAYERS}, {"n_layers": 2}),
             "recurrentgemma-9b": ({"n_layers": 3},
                                   {"n_layers": 3, "vocab": 32000}),
             "whisper-small": ({"n_layers": 1, "enc_layers": 1},
                               {"n_layers": 1, "enc_layers": 1})}
TP_CKPT = "mamba2-370m"
TP_BF16_RTOL = {"mamba2-370m": (mamba_bf16_limit("loss", MAMBA_LAYERS),
                                mamba_bf16_limit("grad_norm",
                                                 MAMBA_LAYERS)),
                "recurrentgemma-9b": (2.5e-5, 4e-4),
                "whisper-small": (2.5e-5, 2e-3)}
TP_TIMEOUT = 1200.0
TP_DIR = os.path.join(HERE, "build", "tp")
#: a rehearsal on the CPU trains the reduced configs (the job carries it)
TP_REDUCED = False

# the tp_uneven phase: tensor parallelism over a "model" axis that does not
# split the heads evenly (rank r of M computes heads [r·H // M, (r+1)·H //
# M): sharding/tp.py::head_range; the attention weights taken whole over
# "model" and sliced), one process a point of the UNEVEN_GRID grid
# sharing the card over gloo (no FSDP: "data" holds one process), run as the
# tp_train phase (run_tp_train) with the train phase's batch,
# microbatches and learning rate, TP_STEPS bf16 steps through Trainer (no
# checkpoint) and a float32 run of TP_EXACT_STEPS steps.
# Whisper-small at its published widths (D 768, 12 heads and 12 KV heads
# of 64, 1500 frames, vocabulary 51865; each rank holds 1.5 query heads'
# columns of wq and computes 1 or 2 heads) cut to 1 encoder and 1 decoder
# layer for time (its encoder attention runs 375 key blocks in Python on
# eight ranks sharing the host).  The first bf16 step's loss and
# grad_norm against one process's within UNEVEN_BF16_RTOL (~3x the
# measured on an NVIDIA H100 80GB HBM3 at 700 W: 1.13e-6 and 6.98e-5);
# float32: loss and grad_norm within UNEVEN_EXACT_RTOL (measured 0 and
# 0), the first step's gradient within SHARD_EXACT_RTOL of its largest
# (7.29e-7), parameters within SHARD_EXACT_PARAM (2.80e-5)
UNEVEN_GRID, UNEVEN_AXES = (1, 8), ("data", "model")
UNEVEN_MODELS = {"whisper-small": ({"n_layers": 1, "enc_layers": 1},
                                   {"n_layers": 1, "enc_layers": 1})}
UNEVEN_BF16_RTOL = {"whisper-small": (3.5e-6, 2.1e-4)}
UNEVEN_EXACT_RTOL = 1e-6
UNEVEN_TIMEOUT = 600.0
UNEVEN_DIR = os.path.join(HERE, "build", "tp_uneven")
#: a rehearsal on the CPU trains the reduced configs (the job carries it)
UNEVEN_REDUCED = False

# the tp_production phase, run by `chip_smoke.py --production-grid` and not
# by the whole script (its ~200 s do not fit the script's time): the
# tp_uneven phase on the reference's 16-way "model" axis, PRODUCTION_GRID
# ((1, 16), src/repro/launch/mesh.py), both models in one spawn of 16
# processes, PRODUCTION_MB (else TRAIN_MB) microbatches.
# Granite-MoE 3B-A800M at its published widths (D 1536, 24 heads and 8 KV
# heads of 64, 40 experts top-8 of d_ff 512, vocabulary 49155) on the
# reference's 16-way "model" axis, (1, 16), where 16 divides none of
# them: each rank computes 1 or 2 heads ([24r // 16, 24(r+1) // 16)),
# query head h reads KV head h // 3 of wk/wv taken whole, all 40
# experts stay whole on every rank and route in one global group, and
# the embedding stays whole (drop_indivisible).  Cut to 1 layer.  Its
# memory, reckoned before its first run on my CPU (launch/dryrun.py on
# the abstract (1, 16) grid, the meta device): state_bytes per rank, bf16
# parameters 340,798,464 B (the 49155 x 1536 embedding and the 40
# experts whole, the attention's 1/16), gradient 340,798,464, float32
# accumulator 681,332,736 and AdamW moments 1,362,665,476: 2.73 GB;
# count_pass's saved activations 75.6 MB at 2 microbatches, 37.8 MB at
# 4; the transients, one 512-token chunk of the unsplit vocabulary's
# logits (B_mb x 512 x 49155: bf16, float32 and its gradient, ~1.0 GB at
# 2 microbatches, ~0.5 GB at 4) and the expert buffers (40 x C x 1536,
# 0.13 or 0.06 GB); ~0.5 GB of CUDA context.  So Granite takes PRODUCTION_MB
# = 4 microbatches of the same 8 x 1024-token batch (T = 2,048 a rank),
# a change of microbatching, not of widths.  Left out of that reckoning
# and found on the card (NVIDIA H100 80GB HBM3, 700.00 W): the AdamW
# update's float32 temporaries of the largest leaf, the 49155 x 1536
# embedding (302 MB each), five or six at once by my count; the first
# two runs ran out of the card's 79.18 GiB in the update (79.04 and
# 78.22 GiB in use).  optim/adamw.py::apply_updates now updates float32
# moments in place and each leaf in slices of 16 M elements (the same
# bits; its temporaries ~0.2 GB).  The float32 run's state is 3.41 GB a
# rank (~80 GB for 16 with the transients and contexts), so it is cut to
# a vocabulary of 16385, which 16 still does not divide (the embedding
# stays whole): 25.2 M rows of embedding, ~1.0 GB a rank less
# (RecurrentGemma's float32 run in tp_train is cut the same way).
# Whisper-small as in tp_uneven, each rank holding 0.75 query heads'
# columns of wq and computing 0 or 1 heads (ranks 0, 4, 8 and 12 compute
# none and join every collective).  The first bf16 step's loss and
# grad_norm against one process's within PRODUCTION_BF16_RTOL: Granite's
# ~3x the measured on an NVIDIA H100 80GB HBM3 at 700 W (9.97e-6 and
# 1.63e-4: one draw at one layer, not a depth model as Mamba-2's),
# Whisper's tp_uneven's (measured 2.25e-6 and 7.21e-5); float32 as
# tp_uneven's, Granite's replaying one process's routing (RouteTape, as
# the ep_train phase's), every other choice within EP_TIE of a tie
PRODUCTION_GRID = (1, 16)
PRODUCTION_MODELS = {"granite-moe-3b-a800m": ({"n_layers": 1},
                                              {"n_layers": 1,
                                               "vocab": 16385}),
                     **UNEVEN_MODELS}
PRODUCTION_MB = {"granite-moe-3b-a800m": 4}
PRODUCTION_BF16_RTOL = {"granite-moe-3b-a800m": (3e-5, 5e-4),
                        **UNEVEN_BF16_RTOL}
PRODUCTION_DIR = os.path.join(HERE, "build", "tp_production")

# the dryrun phase: the port's dry-run accounting (repro_torch.launch.
# dryrun, the meta device, abstract grids, nothing allocated) of the
# paper's cell in both variants on both production grids, of these
# (arch, shape) cells on the single-pod grid, and of train_tinyllama's own
# step on a 1x1 grid, held against that step as the train phase measured it
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k"),
                ("granite-moe-3b-a800m", "decode_32k"))
# the examples phase: the six examples/torch_*.py at their defaults on the
# card (the "matmul" route: no hand kernel launches), torch_train_lm at
# the fewest steps its loss check allows, all within EXAMPLES_MAX_S
EXAMPLE_TRAIN_STEPS = 20
EXAMPLES_MAX_S = 120.0

# H100 SXM published peaks (NVIDIA data sheet): HBM, fp32 without tensor
# cores, dense TF32 on the tensor cores (every kernel: three TF32 products
# per fp32-accurate product)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

# kernel vs plain version: both fp32, sums in another order; relative to
# the largest output magnitude
KERNEL_RTOL = 1e-5
# kernel #1's factored mode vs its plain version: 3xTF32 against complex64
# products, two stages and a twiddle each (3.3-4.2e-7 measured on the H100)
FACTORED_RTOL = 2e-6
# kernel route vs matmul route over the whole SCF: fp32 rounding of
# 1.1M-lane Gram sums and 16.7M-point cube reductions, carried through
# three mixed iterations (2e-6 relative measured at n = 16 on the CPU)
ENERGY_RTOL = 1e-4
EIG_ATOL = 1e-4
RHO_RTOL = 1e-3


# earlier times, for comparison within the printout only: the sphere
# kernels on the SIMT GEMM before this design, and kernel #1 by line shape
# (lines, n_in, n_out, inverse), from PERF.md's call C (NVIDIA H100 80GB
# HBM3, 700.00 W)
SIMT_MS = {"unpack_dft": 3.683, "dft_pack": 3.780}
CALL_C_MS = {
    (2097152, 128, 256, True): 5.690, (2097152, 256, 128, False): 5.342,
    (1048576, 128, 256, True): 2.733, (1048576, 256, 128, False): 2.582,
    (524288, 128, 256, True): 1.389, (524288, 256, 128, False): 1.314,
    (524288, 256, 64, False): 0.689, (524288, 64, 256, True): 0.778,
    (262144, 128, 256, True): 0.699, (262144, 256, 128, False): 0.666,
    (131072, 256, 128, False): 0.358, (131072, 128, 256, True): 0.366,
    (131072, 64, 256, True): 0.210, (131072, 256, 64, False): 0.192,
    (65536, 256, 256, True): 0.355, (262144, 64, 64, True): 0.117,
    (65536, 256, 256, False): 0.378, (262144, 64, 64, False): 0.116,
    (65536, 128, 256, True): 0.194, (65536, 256, 128, False): 0.193,
    (32768, 256, 64, False): 0.061, (32768, 64, 256, True): 0.064}


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    print(("  ok   " if ok else "  FAIL ") + what, flush=True)
    if not ok:
        raise CheckFailed(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# cgemm_tc.cuh's ways to load the x^ tile, by template argument
A_PATHS = ("A_ROWS", "A_GATHER", "A_COLS")


def ptxas_summary(log: str) -> list[tuple[str, str]]:
    """(kernel, "stack, spills; registers, barriers") per entry function
    of a ``-Xptxas -v`` log, with the tensor-core GEMM's template
    arguments spelled out."""
    import re
    out: dict[str, list[str]] = {}
    name = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            m = re.search(r"cgemm_tc_kernelILi(\d)EN(?:S_|4dftk)(\d+)(\w+)",
                          name)
            if m:
                name = (f"cgemm_tc_kernel<{A_PATHS[int(m[1])]}, "
                        f"{m[3][:int(m[2])]}>")
            m = re.search(r"cgemm_tc_factored_kernelILi(\d)ELi(\d+)ELi(\d+)E",
                          name)
            if m:
                name = (f"cgemm_tc_factored_kernel<{A_PATHS[int(m[1])]}, "
                        f"{m[2]}, {m[3]}>")
            out[name] = []
        elif name and ("registers" in line or "spill" in line):
            out[name].append(line.split("info    :")[-1].strip())
    return [(k, "; ".join(v)) for k, v in out.items()]


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` launches."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def wall_ms(torch, fn, reps: int = 2) -> float:
    """Host-clock ms of ``fn()`` between device synchronizations (none on
    a machine without CUDA), mean of ``reps`` calls after one warm-up
    call."""
    def drain():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    fn()
    drain()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    drain()
    return (time.perf_counter() - t0) / reps * 1e3


def bound_ms(nbytes: float, flops: float) -> dict:
    """The least time of work that moves ``nbytes`` and does ``flops``
    fp32-accurate FLOP, two ways: on fp32 FMA (67 TFLOP/s) and on the
    tensor cores as three TF32 products (3·FLOP at 495 TFLOP/s), each the
    larger of its operations' and the bytes' time (3.35 TB/s).
    ``bound_ms`` is the lesser of the two, the least the card could take."""
    t_mem = nbytes / HBM_BYTES_PER_S
    out = {}
    for name, t_ops in (("fp32_fma", flops / FP32_FLOP_PER_S),
                        ("tf32x3", 3.0 * flops / TF32_FLOP_PER_S)):
        out[f"{name}_bound_ms"] = max(t_mem, t_ops) * 1e3
        out[f"{name}_bound_by"] = "bytes" if t_mem >= t_ops else "operations"
    least = min(("fp32_fma", "tf32x3"), key=lambda n: out[f"{n}_bound_ms"])
    out["bound_ms"] = out[f"{least}_bound_ms"]
    out["bound_by"] = out[f"{least}_bound_by"]
    return out


def bound_text(b: dict) -> str:
    return (f"bound {b['tf32x3_bound_ms']:.3f} ms on 3xTF32 tensor cores "
            f"({b['tf32x3_bound_by']}), {b['fp32_fma_bound_ms']:.3f} ms on "
            f"fp32 FMA ({b['fp32_fma_bound_by']})")


def rel_err(torch, got, want) -> tuple[float, float]:
    """(max abs error, that over max |want|) for tensors or numpy arrays
    (pass ``numpy`` as the first argument for the latter)."""
    err = float(abs(got - want).max())
    return err, err / max(float(abs(want).max()), 1e-30)


def is_plus_zero(torch, t) -> bool:
    """Every element exactly +0.0 (real and imaginary parts)."""
    f = torch.view_as_real(t) if t.is_complex() else t
    return bool(((f == 0) & ~torch.signbit(f)).all())


def crandn(torch, gen, shape, device):
    re = torch.randn(shape, generator=gen, device=device)
    im = torch.randn(shape, generator=gen, device=device)
    return torch.complex(re, im)


# ------------------------------------------------------------------ kernels
# kernel #1's edge cases beside the SCF's shapes: (M, K, N, rows past M
# NaN-poisoned).  Odd K takes the gather path (a row pitch TMA cannot
# address); no M is a whole number of 128-row tiles
EDGE_CASES = ((1000, 24, 40, False), (300, 5, 5, False), (300, 9, 18, False),
              (77, 1, 3, False), (77, 8, 1, False), (1, 8, 8, False),
              (389, 128, 256, False), (1000, 24, 40, True),
              (500, 9, 18, True))


def edge_rows(torch, gen, M, K, dev, poisoned):
    """(M, K) lines; poisoned: the first M rows of a larger buffer whose
    later rows are NaN, which a read would spread to the outputs."""
    if not poisoned:
        return crandn(torch, gen, (M, K), dev)
    buf = crandn(torch, gen, (M + 77, K), dev)
    buf[M:] = float("nan")
    return buf[:M]


def scf_stage_reads():
    """The SCF H apply's line stages that read strided planes, as
    ``(name, planes, K, L, N, inverse)``: idft[x] on #3's (b, x, y, z),
    idft[y] on (b, y, z, X), dft[X] on (b, z, X, y'); its dft[Y] reads
    the cube's rows."""
    B = len(KPTS) * NBANDS
    return ((f"idft[x] {DIAMETER}->{N}", B, DIAMETER, DIAMETER * N, N, True),
            (f"idft[y] {DIAMETER}->{N}", B, DIAMETER, N * N, N, True),
            (f"dft[X] {N}->{DIAMETER}", B * N, N, DIAMETER, DIAMETER, False))


def bitwise(torch, a, b) -> bool:
    return bool(torch.equal(torch.view_as_real(a), torch.view_as_real(b)))


def check_dft_matmul(torch, dev, gen):
    from repro_torch.core.local_fft import dft_matrix_device
    from repro_torch.kernels.dft_matmul import (dft_matmul, dft_matmul_cols,
                                                dft_matmul_cols_plain,
                                                dft_matmul_plain)
    from repro_torch.kernels.ops import dft_operand_device
    print("dft_matmul (kernel #1): complex line-DFT GEMM, split TF32 on the "
          "tensor cores", flush=True)
    worst = 0.0
    for M, K, Nn, poisoned in EDGE_CASES:
        x = edge_rows(torch, gen, M, K, dev, poisoned)
        _, _, w = dft_matrix_device(Nn, K, True, dev)
        y = dft_matmul(x, w)
        finite = bool(torch.isfinite(torch.view_as_real(y)).all())
        _, rel = rel_err(torch, y, dft_matmul_plain(x, w))
        worst = max(worst, rel)
        check(finite and rel <= KERNEL_RTOL,
              f"{M}x{K}->{Nn}{' poisoned rows past M' if poisoned else ''}"
              f": finite, rel err {rel:.3e} <= {KERNEL_RTOL:g}")
    # forward truncating y-stage shape of the stacked H apply
    B = len(KPTS) * NBANDS
    x = crandn(torch, gen, (B * DIAMETER * N, N), dev)
    _, _, w = dft_matrix_device(DIAMETER, N, False, dev)
    _, rel = rel_err(torch, dft_matmul(x, w), dft_matmul_plain(x, w))
    check(rel <= KERNEL_RTOL, f"forward {x.shape[0]}x{N}->{DIAMETER}: rel "
          f"err {rel:.3e} <= {KERNEL_RTOL:g}")
    del x
    # the SCF's strided stages as the line stages launch them: the strided
    # entry on the planes where they lie, against its plain version and bit
    # for bit the rows entry on the same lines copied into rows; timed at
    # the largest, idft[y] (the kernels line's time), with the rows entry
    # beside it
    for name, P, K, L, Nn, inverse in scf_stage_reads():
        M = P * L
        x = crandn(torch, gen, (P, K, L), dev)
        _, _, w = dft_matrix_device(Nn, K, inverse, dev)
        ws = dft_operand_device(Nn, K, inverse, w.device)
        y = dft_matmul_cols(x, w, wsplit=ws)
        rows = x.transpose(1, 2).contiguous().view(M, K)
        same = bitwise(torch, y, dft_matmul(rows, w, wsplit=ws))
        yp = dft_matmul_cols_plain(x, w)
        err, rel = rel_err(torch, y, yp)
        check(rel <= KERNEL_RTOL and same,
              f"{name} strided ({P}, {K}, {L}) -> ({M}, {Nn}): max abs err "
              f"{err:.3e}, rel {rel:.3e} <= {KERNEL_RTOL:g}; bitwise the "
              "rows entry on the same lines")
        del y, yp
        if L != N * N:
            del x, rows
            continue
        ms = time_ms(torch, lambda: dft_matmul_cols(x, w, wsplit=ws))
        rows_ms = time_ms(torch, lambda: dft_matmul(rows, w, wsplit=ws))
        plain = time_ms(torch, lambda: dft_matmul_cols_plain(x, w), reps=5)
        lib = time_ms(torch, lambda: torch.matmul(rows, w.T))
        b = bound_ms(8.0 * (M * K + Nn * K + M * Nn), 8.0 * M * Nn * K)
        shape = f"({P},{K},{L}) strided->({M},{Nn})"
        print(f"  {name}: time {ms:.3f} ms strided, {rows_ms:.3f} ms as "
              f"rows, plain {plain:.3f} ms, complex64 torch.matmul "
              f"{lib:.3f} ms, {bound_text(b)}", flush=True)
        check(ms < lib, f"kernel {ms:.3f} ms faster than complex64 "
              f"torch.matmul {lib:.3f} ms")
        timed = {"max_abs_err": err, "rel_err": rel, "ms": ms,
                 "rows_ms": rows_ms, "plain_ms": plain, **b,
                 "library_ms": lib, "shape": shape}
        del x, rows
    oracle = check_dft_apply_oracle(torch, dev, gen)
    return {"name": "dft_matmul", **timed, "fft_oracle_rel_err": oracle,
            "edge_max_rel_err": worst, "tolerance": KERNEL_RTOL}


def check_dft_apply_oracle(torch, dev, gen) -> float:
    """Kernel #1 through ``kernels.ops.dft_apply`` on CUDA tensors (the
    "cuda" route's line DFT) against ``kernels.ref.dft_apply_ref``
    (``torch.fft`` of the padded or truncated line, no DFT matrix) at the
    SCF's line shapes, d → n and n → n, both directions; returns the
    largest error relative to the largest value."""
    from repro_torch.kernels.dft_matmul import dft_matmul
    from repro_torch.kernels.ops import dft_apply
    from repro_torch.kernels.ref import dft_apply_ref
    B = len(KPTS) * NBANDS
    worst = 0.0
    for M, n_in, n_out in ((B * DIAMETER * N, DIAMETER, N), (N * N, N, N)):
        x = crandn(torch, gen, (M, n_in), dev)
        for inverse in (True, False):
            before = dft_matmul.launches
            y = dft_apply(x, n_out, inverse=inverse)
            launched = dft_matmul.launches - before
            _, rel = rel_err(torch, y, dft_apply_ref(x, n_out,
                                                     inverse=inverse))
            del y
            worst = max(worst, rel)
            check(launched == 1 and rel <= KERNEL_RTOL,
                  f"dft_apply {'inverse' if inverse else 'forward'} {M}x"
                  f"{n_in}->{n_out} vs torch.fft oracle: 1 launch, rel err "
                  f"{rel:.3e} <= {KERNEL_RTOL:g}")
        del x
    torch.cuda.empty_cache()
    return worst


# the sphere kernels' edge cases beside the SCF's shapes: (d, n, k-points,
# bands[, slab layout]).  d = 6: rows never whole 128-line tiles, ey = 6
# (tiles straddle planes), 2d = 12 < one 32-column K chunk; d = 8: ey = 8;
# d = 40: K chunks skipped in the edge tiles, and an ey that the strided
# read does not fit (a y-plane slab is copied; a z-major one's ex·ey = 1600
# lines fit); odd n: dft_pack's gather path
KPTS3 = ((0.25, 0.0, 0.5), (0.0, 0.0, 0.0), (0.5, 0.5, 0.0))
UNPACK_EDGE_CASES = ((6, 12, KPTS, 3), (8, 16, KPTS, 3), (40, 80, KPTS3, 2))
PACK_EDGE_CASES = ((6, 12, KPTS, 3, "rows"), (6, 9, KPTS3, 2, "rows"),
                   (8, 16, KPTS, 3, "x-planes"), (8, 16, KPTS, 3, "y-planes"),
                   (8, 15, KPTS3, 2, "y-planes"),
                   (40, 80, KPTS3, 2, "y-planes"),
                   (8, 16, KPTS, 3, "z-major"), (6, 12, KPTS, 3, "z-major"),
                   (40, 80, KPTS3, 2, "z-major"))


def slab_as(torch, gen, B, d, n, layout, dev):
    """A (B, d, d, n) slab stored as ``layout`` says: "rows" contiguous
    lines, "z-major" each row's slab z-major, then y, then x (as the x
    stage of the stacked SCF's forward plan leaves it: slab layout 2),
    "y-planes" each y plane z-major (layout 1), "x-planes" each x plane
    z-major (which dft_pack copies first)."""
    if layout == "rows":
        return crandn(torch, gen, (B, d, d, n), dev)
    if layout == "z-major":
        return crandn(torch, gen, (B, n, d, d), dev).permute(0, 3, 2, 1)
    s = crandn(torch, gen, (B, d, n, d), dev)
    return s.transpose(2, 3) if layout == "x-planes" else s.permute(0, 3, 1,
                                                                    2)


def sphere_tables(torch, dev, spheres, nbands):
    from repro_torch.kernels import sphere_pack as sp
    return tuple(torch.as_tensor(t, device=dev)
                 for t in sp.line_tables(spheres, nbands))


def poisoned_lanes(torch, gen, spheres, nbands, dev):
    """(B, npacked_max) lanes whose lanes past each row's sphere are NaN:
    a read would poison the row's outputs."""
    npk = max(s.npacked for s in spheres)
    packed = crandn(torch, gen, (len(spheres) * nbands, npk), dev)
    for k, s in enumerate(spheres):
        packed[k * nbands:(k + 1) * nbands, s.npacked:] = float("nan")
    return packed


def check_unpack_case(torch, dev, gen, d, n, kpts, nbands) -> float:
    """unpack_dft at a small sphere set: NaN lanes unread, cnt = 0 lines
    and a flag = 0 plane with support bitwise +0.0; returns the rel err."""
    from repro_torch.core import kpoint_sphere
    from repro_torch.core.local_fft import dft_matrix_device
    from repro_torch.kernels import sphere_pack as sp
    spheres = [kpoint_sphere(d, k) for k in kpts]
    start, zlo, cnt, flag = sphere_tables(torch, dev, spheres, nbands)
    packed = poisoned_lanes(torch, gen, spheres, nbands, dev)
    _, _, w = dft_matrix_device(n, d, True, dev)
    flag0 = flag.clone()
    flag0[d // 2] = 0
    worst = 0.0
    for fl in (flag, flag0):
        y = sp.unpack_dft(packed, start, zlo, cnt, fl, w)
        _, rel = rel_err(torch, y, sp.unpack_dft_plain(packed, start, zlo,
                                                       cnt, fl, w))
        worst = max(worst, rel)
        empty = (cnt == 0).reshape(y.shape[:3])
        check(bool(torch.isfinite(torch.view_as_real(y)).all())
              and rel <= KERNEL_RTOL and is_plus_zero(torch, y[empty]),
              f"d={d} n={n} {len(kpts)} k x {nbands} bands"
              f"{' flag=0 plane' if fl is flag0 else ''}: no NaN lane read,"
              f" rel err {rel:.3e}, {int(empty.sum())} cnt=0 lines +0.0")
    check(int((cnt.reshape(y.shape[:3])[:, d // 2] > 0).sum()) > 0
          and is_plus_zero(torch, y[:, d // 2]),
          f"d={d}: the flag=0 plane {d // 2}, which has support, is +0.0")
    return worst


def gather_cost(torch, dev, gen, M, d, n) -> dict:
    """Kernel #1 on M dense lines of d -> n, once with x 16-byte aligned
    (TMA) and once 8 bytes off (the wrapper then takes the gather path
    that unpack_dft uses): what the gather costs apart from the sphere."""
    from repro_torch.core.local_fft import dft_matrix_device
    from repro_torch.kernels.dft_matmul import dft_matmul
    from repro_torch.kernels.ops import dft_operand_device
    buf = crandn(torch, gen, (M * d + 2,), dev)
    aligned = buf[:M * d].view(M, d)
    shifted = buf[1:M * d + 1].view(M, d)
    if aligned.data_ptr() % 16:
        aligned, shifted = shifted, aligned
    _, _, w = dft_matrix_device(n, d, True, dev)
    ws = dft_operand_device(n, d, True, w.device)
    out = {name: time_ms(torch, lambda x=x: dft_matmul(x, w, wsplit=ws))
           for name, x in (("tma_ms", aligned), ("gather_ms", shifted))}
    del buf
    return out


def check_unpack_dft(torch, dev, gen, spheres):
    from repro_torch.core.local_fft import dft_matrix_device
    from repro_torch.kernels import sphere_pack as sp
    from repro_torch.kernels.ops import dft_operand_device
    print("unpack_dft (kernel #3): CSR gather + d->n line DFT, split TF32 "
          "on the tensor cores", flush=True)
    edge = max(check_unpack_case(torch, dev, gen, *case)
               for case in UNPACK_EDGE_CASES)
    start, zlo, cnt, flag = sphere_tables(torch, dev, spheres, NBANDS)
    B, nl = start.shape
    npk = max(s.npacked for s in spheres)
    packed = poisoned_lanes(torch, gen, spheres, NBANDS, dev)
    _, _, w = dft_matrix_device(N, DIAMETER, True, dev)
    # the SCF path's cached arguments
    chunks = sp.chunk_ranges(zlo, cnt, flag)
    ws = dft_operand_device(N, DIAMETER, True, w.device)

    def kernel(table=chunks):
        return sp.unpack_dft(packed, start, zlo, cnt, flag, w, chunks=table,
                             wsplit=ws)
    y = kernel()
    yp = sp.unpack_dft_plain(packed, start, zlo, cnt, flag, w)
    err, rel = rel_err(torch, y, yp)
    check(bool(torch.isfinite(torch.view_as_real(y)).all()),
          "no padded (NaN) lane was read")
    check(rel <= KERNEL_RTOL, f"({B}, {npk}) -> {tuple(y.shape)}: max abs "
          f"err {err:.3e}, rel {rel:.3e} <= {KERNEL_RTOL:g}")
    empty = (cnt == 0).reshape(B, DIAMETER, DIAMETER)
    check(is_plus_zero(torch, y[empty]),
          f"{int(empty.sum())} lines with cnt=0 are bitwise +0.0")
    flag0 = flag.clone()
    planes = [0, 1, 3 * DIAMETER // 5]
    flag0[planes] = 0
    y0 = sp.unpack_dft(packed, start, zlo, cnt, flag0, w, wsplit=ws)
    check(is_plus_zero(torch, y0[:, planes]),
          f"flag=0 planes {planes} are bitwise +0.0")
    check(bool(torch.equal(y0[:, 2], y[:, 2])),
          "planes with flag=1 are unchanged by the zero-skip")
    del y, yp, y0
    # what the chunk table skips per launch: row tiles with no active
    # line, and K chunks outside each tile's active lines
    nk = -(-2 * DIAMETER // 32)
    tiles_n = -(-2 * N // 128)
    first, last = chunks[:, 0].long(), chunks[:, 1].long()
    skip = {"row_tiles": int(chunks.shape[0]),
            "row_tiles_skipped": int((last == first).sum()),
            "chunk_loads": int(chunks.shape[0]) * nk * tiles_n,
            "chunk_loads_skipped": int((nk - (last - first)).sum()) * tiles_n}
    print(f"  per launch: {skip['row_tiles_skipped']} of {skip['row_tiles']}"
          f" 128-line tiles skipped, {skip['chunk_loads_skipped']} of "
          f"{skip['chunk_loads']} K-chunk loads skipped ({tiles_n} column "
          f"tiles x {nk} chunks per row tile)", flush=True)
    full = torch.stack((torch.zeros_like(first), torch.full_like(last, nk)),
                       1).to(torch.int32).contiguous()
    ms = time_ms(torch, kernel)
    ms_full = time_ms(torch, lambda: kernel(full))
    gather = gather_cost(torch, dev, gen, B * nl, DIAMETER, N)
    plain = time_ms(torch, lambda: sp.unpack_dft_plain(
        packed, start, zlo, cnt, flag, w), reps=5)
    lanes = float(cnt.sum())                       # this run's packed lanes
    nbytes = 8.0 * (lanes + N * DIAMETER + B * nl * N) + 4.0 * 3 * B * nl
    b = bound_ms(nbytes, 8.0 * N * lanes)
    print(f"  time {ms:.3f} ms ({ms_full:.3f} ms reading every K chunk; "
          f"{SIMT_MS['unpack_dft']:.3f} ms on the SIMT GEMM, call C), plain "
          f"{plain:.3f} ms, {bound_text(b)}; no single torch call computes "
          "it", flush=True)
    print(f"  the gather itself: kernel #1 on the same {B * nl} dense lines "
          f"{gather['gather_ms']:.3f} ms through the gather path against "
          f"{gather['tma_ms']:.3f} ms by TMA", flush=True)
    return {"name": "unpack_dft", "max_abs_err": err, "rel_err": rel,
            "edge_max_rel_err": edge, "tolerance": KERNEL_RTOL, "ms": ms,
            "every_chunk_ms": ms_full, "simt_call_c_ms": SIMT_MS["unpack_dft"],
            "dense_lines": gather,
            "plain_ms": plain, **b, "library_ms": None, **skip,
            "shape": f"({B},{npk})->({B},{DIAMETER},{DIAMETER},{N})"}


def check_pack_case(torch, dev, gen, d, n, kpts, nbands, layout) -> float:
    """dft_pack at a small sphere set: padded lanes bitwise +0.0; the
    strided slab is read in place where its ey fits; returns the rel err."""
    import numpy as np

    from repro_torch.core import kpoint_sphere
    from repro_torch.core.local_fft import dft_matrix_device
    from repro_torch.kernels import sphere_pack as sp
    spheres = [kpoint_sphere(d, k) for k in kpts]
    start, zlo, cnt, _ = sphere_tables(torch, dev, spheres, nbands)
    B, npk = start.shape[0], max(s.npacked for s in spheres)
    slab = slab_as(torch, gen, B, d, n, layout, dev)
    nvalid = torch.as_tensor(np.repeat(np.asarray(
        [s.npacked for s in spheres], np.int32), nbands), device=dev)
    _, _, w = dft_matrix_device(d, n, False, dev)
    out = sp.dft_pack(slab, start, zlo, cnt, nvalid, w, npk)
    _, rel = rel_err(torch, out, sp.dft_pack_plain(slab, start, zlo, cnt,
                                                   nvalid, w, npk))
    pad = torch.arange(npk, device=dev)[None, :] >= nvalid.long()[:, None]
    how = "after a copy" if sp.slab_layout(slab) is None else "in place"
    check(bool(torch.isfinite(torch.view_as_real(out)).all())
          and rel <= KERNEL_RTOL and int(pad.sum()) > 0
          and is_plus_zero(torch, out[pad]),
          f"d={d} n={n} {len(kpts)} k x {nbands} bands, {layout} slab "
          f"(read {how}): rel err {rel:.3e}, {int(pad.sum())} padded lanes "
          "+0.0")
    return rel


def check_dft_pack(torch, dev, gen, spheres):
    import numpy as np

    from repro_torch.core.local_fft import dft_matrix_device
    from repro_torch.kernels import build
    from repro_torch.kernels import sphere_pack as sp
    from repro_torch.kernels.ops import dft_operand_device
    print("dft_pack (kernel #4): n->d line DFT + CSR pack, split TF32 on the "
          "tensor cores", flush=True)
    edge = max(check_pack_case(torch, dev, gen, *case)
               for case in PACK_EDGE_CASES)
    start, zlo, cnt, _ = sphere_tables(torch, dev, spheres, NBANDS)
    B, nl = start.shape
    npk = max(s.npacked for s in spheres)
    nvalid = torch.as_tensor(np.repeat(np.asarray(
        [s.npacked for s in spheres], np.int32), NBANDS), device=dev)
    # the slab as the forward plan's x stage leaves it, each row's slab
    # z-major (layout 2); the same values with each y plane z-major
    # (layout 1) and with contiguous lines (layout 0)
    strided = slab_as(torch, gen, B, DIAMETER, N, "z-major", dev)
    rows = strided.contiguous()
    planes = rows.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    check((sp.slab_layout(strided), sp.slab_layout(planes),
           sp.slab_layout(rows)) == (2, 1, 0),
          "the z-major and the y-plane slab are read in place, the "
          "contiguous one by rows")
    _, _, w = dft_matrix_device(DIAMETER, N, False, dev)
    ws = dft_operand_device(DIAMETER, N, False, w.device)
    outp = sp.dft_pack_plain(rows, start, zlo, cnt, nvalid, w, npk)
    pad = (torch.arange(npk, device=dev)[None, :]
           >= nvalid.long()[:, None])
    errs, outs = {}, {}
    for name, slab in (("strided", strided), ("y-planes", planes),
                       ("rows", rows)):
        out = sp.dft_pack(slab, start, zlo, cnt, nvalid, w, npk, wsplit=ws)
        errs[name] = rel_err(torch, out, outp)
        check(errs[name][1] <= KERNEL_RTOL, f"{name} {tuple(slab.shape)} ->"
              f" ({B}, {npk}): max abs err {errs[name][0]:.3e}, rel "
              f"{errs[name][1]:.3e} <= {KERNEL_RTOL:g}")
        check(int(pad.sum()) > 0 and is_plus_zero(torch, out[pad]),
              f"{name}: {int(pad.sum())} padded lanes are bitwise +0.0")
        outs[name] = out
    check(bitwise(torch, outs["strided"], outs["rows"])
          and bitwise(torch, outs["y-planes"], outs["rows"]),
          "slab layouts 2, 1 and 0 give the same bits")
    del outp, outs, out
    ms = time_ms(torch, lambda: sp.dft_pack(strided, start, zlo, cnt, nvalid,
                                            w, npk, wsplit=ws))
    ms_planes = time_ms(torch, lambda: sp.dft_pack(
        planes, start, zlo, cnt, nvalid, w, npk, wsplit=ws))
    ms_rows = time_ms(torch, lambda: sp.dft_pack(rows, start, zlo, cnt,
                                                 nvalid, w, npk, wsplit=ws))
    copy_ms = time_ms(torch, lambda: strided.contiguous(), reps=5)
    out = torch.empty((B, npk), dtype=torch.complex64, device=dev)
    lib = build.library("sphere_pack")

    def tail():
        build.check(lib.pack_zero_tail_launch(
            out.data_ptr(), nvalid.data_ptr(), B, npk,
            torch.cuda.current_stream(dev).cuda_stream), "zero tail")
    tail_ms = time_ms(torch, tail)
    plain = time_ms(torch, lambda: sp.dft_pack_plain(
        strided, start, zlo, cnt, nvalid, w, npk), reps=5)
    lanes = float(nvalid.sum())                    # this run's valid lanes
    nbytes = (8.0 * (strided.numel() + DIAMETER * N + B * npk)
              + 4.0 * (3 * B * nl + B))
    b = bound_ms(nbytes, 8.0 * N * lanes)
    print(f"  time {ms:.3f} ms reading the z-major slab in place, "
          f"{ms_planes:.3f} ms the y-plane one, "
          f"{ms_rows:.3f} ms from contiguous lines (the copy it saves: "
          f"{copy_ms:.3f} ms; {SIMT_MS['dft_pack']:.3f} ms on the SIMT GEMM "
          f"after that copy, call C); of which the +0.0 tail kernel "
          f"{tail_ms:.3f} ms; plain {plain:.3f} ms, {bound_text(b)}; no "
          "single torch call computes it", flush=True)
    del out
    return {"name": "dft_pack", "max_abs_err": errs["strided"][0],
            "rel_err": errs["strided"][1], "rows_rel_err": errs["rows"][1],
            "y_planes_rel_err": errs["y-planes"][1],
            "edge_max_rel_err": edge, "tolerance": KERNEL_RTOL, "ms": ms,
            "y_planes_ms": ms_planes, "rows_ms": ms_rows,
            "slab_copy_ms": copy_ms,
            "zero_tail_ms": tail_ms, "simt_call_c_ms": SIMT_MS["dft_pack"],
            "plain_ms": plain, **b, "library_ms": None,
            "shape": f"({B},{DIAMETER},{DIAMETER},{N}) z-major"
                     f"->({B},{npk})"}


def check_slab_layout(torch, dev, gen):
    """Whether the slab that the fused pack gets on the SCF path (the
    forward plan's lead stages' output, under the eager and the lazy
    executor) is read in place: its layout, and the time of the
    ``contiguous()`` copy the kernel does not need."""
    from repro_torch.core.policy import ExecPolicy
    from repro_torch.dft.basis import PlaneWaveBasis
    from repro_torch.kernels import sphere_pack as sp
    b = PlaneWaveBasis(N, diameter=DIAMETER, kpts=KPTS, nbands=NBANDS,
                       backend="cuda", device=dev)
    _, fwd = b.stacked_hamiltonian_plans()
    parts = fwd._fused_out_parts()
    cube = crandn(torch, gen, (b.nk * NBANDS, N, N, N), dev)
    out = {}
    for mode in ("eager", "lazy"):
        pol = ExecPolicy(mode=mode)
        slab = parts["lead"](cube, policy=pol)
        layout = sp.slab_layout(slab)
        copy_ms = time_ms(torch, lambda: slab.contiguous(), reps=5)
        lead_ms = time_ms(torch, lambda pol=pol: parts["lead"](
            cube, policy=pol), reps=3)
        print(f"fused pack's slab on the SCF path, {mode} lead plan "
              f"({lead_ms:.3f} ms): {tuple(slab.shape)}, strides "
              f"{slab.stride()}, contiguous {slab.is_contiguous()}: "
              + ({0: "contiguous lines, read in place, no copy",
                  1: "y planes z-major, read in place, no copy",
                  2: "each row's slab z-major, read in place, no copy"}.get(
                      layout, "copied first"))
              + f"; a contiguous() copy of it takes {copy_ms:.3f} ms",
              flush=True)
        check(layout is not None,
              f"dft_pack reads the {mode} SCF path's slab in place")
        out[mode] = {"shape": list(slab.shape),
                     "strides": list(slab.stride()),
                     "contiguous": slab.is_contiguous(), "layout": layout,
                     "copy_ms": copy_ms, "lead_ms": lead_ms}
        del slab
    del cube
    return out


def check_four_step(torch, dev, gen, stages):
    """Kernel #2 against its plain version, then the four-step path.

    Returns the kernel's record and the path's own numbers; the launch
    counts are those of the four-step path's run alone.
    """
    import numpy as np

    from repro_torch.core.local_fft import dft_matrix_device
    from repro_torch.kernels import ops
    from repro_torch.kernels.dft_matmul import (dft_matmul,
                                                dft_matmul_twiddle,
                                                dft_matmul_twiddle_plain)
    from repro_torch.kernels.ref import twiddle_matrix
    print("dft_matmul_twiddle (kernel #2): line-DFT GEMM + twiddle "
          "epilogue", flush=True)
    # (a) edge cases with a general (M, N) table (T = M), and the
    # four-step table of n = 15 = 3·5 (K = 5: the gather path)
    cases = [(M, K, Nn, p, None) for M, K, Nn, p in EDGE_CASES
             if Nn > 1 and K > 1]
    cases.append((50 * 3, 5, 5, False, (3, 5)))
    for M, K, Nn, poisoned, table in cases:
        x = edge_rows(torch, gen, M, K, dev, poisoned)
        _, _, w = dft_matrix_device(Nn, K, False, dev)
        t = (crandn(torch, gen, (M, Nn), dev) if table is None else
             torch.as_tensor(np.ascontiguousarray(
                 twiddle_matrix(*table, False).T), device=dev))
        y = dft_matmul_twiddle(x, w, t)
        finite = bool(torch.isfinite(torch.view_as_real(y)).all())
        _, rel = rel_err(torch, y, dft_matmul_twiddle_plain(x, w, t))
        check(finite and rel <= KERNEL_RTOL,
              f"{M}x{K}->{Nn}, {tuple(t.shape)} table"
              f"{' poisoned rows past M' if poisoned else ''}: finite, rel "
              f"err {rel:.3e} <= {KERNEL_RTOL:g}")
    # (b) stage 1 of four_step_dft: B·n1 lines of n2, the (n1, n2) table
    n1, n2 = ops._factor(FOUR_STEP_N)
    M, K, Nn = FOUR_STEP_LINES * n1, n2, n2
    x = crandn(torch, gen, (M, K), dev)
    _, _, w = dft_matrix_device(Nn, K, False, dev)
    t = torch.as_tensor(np.ascontiguousarray(
        twiddle_matrix(n1, n2, False).T), device=dev)
    ws = ops.dft_operand_device(Nn, K, False, w.device)
    y = dft_matmul_twiddle(x, w, t, wsplit=ws)
    yp = dft_matmul_twiddle_plain(x, w, t)
    err, rel = rel_err(torch, y, yp)
    check(rel <= KERNEL_RTOL, f"stage 1 {M}x{K}->{Nn}, ({n1}, {n2}) "
          f"table: max abs err {err:.3e}, rel {rel:.3e} <= "
          f"{KERNEL_RTOL:g}")
    # the library yardstick: one einsum computes (x·Wᵀ) ⊙ t[row mod n1]
    xb = x.view(M // n1, n1, K)

    def library():
        return torch.einsum("btk,nk,tn->btn", xb, w, t).reshape(M, Nn)

    _, lrel = rel_err(torch, library(), yp)
    check(lrel <= KERNEL_RTOL, f"library einsum computes the same "
          f"function: rel err {lrel:.3e} <= {KERNEL_RTOL:g}")
    del y, yp
    ms = time_ms(torch, lambda: dft_matmul_twiddle(x, w, t, wsplit=ws))
    plain = time_ms(torch, lambda: dft_matmul_twiddle_plain(x, w, t),
                    reps=5)
    lib = time_ms(torch, library)
    gemm = time_ms(torch, lambda: torch.matmul(x, w.T))
    # each input read once (x, W, the table), y written once; the
    # epilogue's complex product is 6 FLOP per output
    b = bound_ms(8.0 * (M * K + Nn * K + n1 * Nn + M * Nn),
                 8.0 * M * Nn * K + 6.0 * M * Nn)
    print(f"  time {ms:.3f} ms, plain {plain:.3f} ms, library einsum "
          f"{lib:.3f} ms, {bound_text(b)}; complex64 torch.matmul of the "
          f"GEMM alone {gemm:.3f} ms", flush=True)
    check(ms < lib, f"kernel {ms:.3f} ms faster than the library einsum "
          f"{lib:.3f} ms")
    del x, xb
    record = {"name": "dft_matmul_twiddle", "max_abs_err": err,
              "rel_err": rel, "tolerance": KERNEL_RTOL, "ms": ms,
              "plain_ms": plain, **b,
              "library_ms": lib, "gemm_alone_ms": gemm,
              "shape": f"{M}x{K}->{Nn} t({n1},{n2})"}

    # (c) the path: four_step_dft on B lines of n, both directions
    print(f"four_step_dft: ({FOUR_STEP_LINES}, {FOUR_STEP_N}) complex64 "
          f"lines, n1={n1} n2={n2}", flush=True)
    lines = crandn(torch, gen, (FOUR_STEP_LINES, FOUR_STEP_N), dev)
    wrappers = (dft_matmul_twiddle, dft_matmul)
    for fn in wrappers:
        fn.launches = 0
    with stages.record("four_step") as shapes:
        fwd = ops.four_step_dft(lines)
        inv = ops.four_step_dft(lines, inverse=True)
    sync(torch, dev)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    check(sum(shapes.values()) == launches["dft_matmul"],
          "the recorded line shapes cover every dft_matmul launch of the "
          "four-step path")
    out = {}
    for name, got, want in (
            ("forward", fwd, torch.fft.fft(lines, dim=-1)),
            ("inverse", inv, torch.fft.ifft(lines, dim=-1))):
        e, r = rel_err(torch, got, want)
        check(r <= KERNEL_RTOL, f"{name} vs torch.fft: max abs err {e:.3e}"
              f", rel {r:.3e} <= {KERNEL_RTOL:g}")
        out[f"{name}_rel_err"] = r
    del fwd, inv
    # (d) the twiddle kernel carried stage 1 of both calls
    print(f"  kernel launches on the four-step path: {launches}",
          flush=True)
    check(launches["dft_matmul_twiddle"] == 2,
          "dft_matmul_twiddle launched once per four_step_dft call")
    check(launches["dft_matmul"] == 2,
          "dft_matmul launched once per four_step_dft call (stage 2)")
    out["ms"] = time_ms(torch, lambda: ops.four_step_dft(lines))
    out["torch_fft_ms"] = time_ms(torch, lambda: torch.fft.fft(lines,
                                                               dim=-1))
    print(f"  four_step_dft {out['ms']:.3f} ms, torch.fft.fft "
          f"{out['torch_fft_ms']:.3f} ms (forward, mean of 10)",
          flush=True)
    out["launches"] = launches
    return record, out


# ----------------------------------------------------- line-DFT shapes
class LineStages:
    """Kernel #1's launches by line shape on each path.

    While ``record(path)`` is active, every ``kernels.ops.dft_apply`` call
    (each launches ``dft_matmul`` once on a CUDA tensor) is counted by
    ``(lines, n_in, n_out, inverse)`` in ``counts[path]``, and by the entry
    it took in ``entries[path]``: the same key and L, 1 for the rows entry,
    the lines a plane for the strided one.  For calls that come through the
    "cuda" backend of ``local_dft`` the route of the stage's
    ``local_fft.LineRead`` is kept in ``routes``, and a stage that copies
    its lines into rows keeps its input's shape, strides and the
    permutation it is copied in (``copies``), so that copy is timed beside
    the kernel.
    """

    def __init__(self):
        from collections import Counter
        self.counts: dict[str, Counter] = {}
        self.entries: dict[str, Counter] = {}
        self.routes: dict[tuple, set] = {}
        self.copies: dict[tuple, tuple] = {}
        self._new = Counter

    def launched(self, path) -> list:
        """The entries kernel #1 took on ``path``: sorted ``(lines, n_in,
        n_out, inverse, L)``."""
        return sorted(self.entries.get(path, ()))

    def record(self, path):
        import contextlib

        from repro_torch.core import local_fft
        from repro_torch.kernels import ops
        counts = self.counts.setdefault(path, self._new())
        entries = self.entries.setdefault(path, self._new())
        apply, backend = ops.dft_apply, local_fft._cuda_backend
        read, taken = local_fft.line_read, []

        def dft_apply(x, n_out=None, *, inverse=False):
            n_in = x.shape[1]
            key = (x.numel() // n_in, n_in, n_out or n_in, bool(inverse))
            counts[key] += 1
            entries[(*key, x.shape[2] if x.ndim == 3 else 1)] += 1
            return apply(x, n_out, inverse=inverse)

        def line_read(x, axis, **kw):
            taken.append(read(x, axis, **kw))
            return taken[-1]

        def cuda_backend(x, axis, n_in, n_out, inverse):
            y = backend(x, axis, n_in, n_out, inverse)
            rd = taken.pop()
            key = (x.numel() // n_in, n_in, n_out, bool(inverse),
                   rd.L if rd.route == "strided" else 1)
            self.routes.setdefault(key, set()).add(rd.route)
            if rd.route == "copied":
                self.copies[key] = (tuple(x.shape), tuple(x.stride()),
                                    (*rd.order, axis % x.ndim))
            return y

        @contextlib.contextmanager
        def patched():
            ops.dft_apply, local_fft._cuda_backend = dft_apply, cuda_backend
            local_fft.line_read = line_read
            try:
                yield counts
            finally:
                ops.dft_apply, local_fft._cuda_backend = apply, backend
                local_fft.line_read = read
        return patched()


def line_entry(torch, gen, dev, M, n_in, n_out, inverse, L):
    """Kernel #1 as a line stage launches it on ``M`` random lines:
    ``(kernel, rows, plain, lines, w, dense)``, ``kernel`` the entry the
    stage takes (the factored mode where ``factored_split`` takes the
    shape, else the dense product; rows, or for ``L`` > 1 the strided
    entry on ``(M / L, n_in, L)`` planes), ``rows`` the same mode's rows
    entry on the same lines in rows (``kernel`` itself when L = 1),
    ``plain`` its plain version, ``lines`` the lines as ``(M, n_in)`` rows
    (a view when L = 1, a copy otherwise), ``w`` the DFT matrix, ``dense``
    the dense product through the same entry where the stage is factored
    (else None)."""
    from repro_torch.core.local_fft import dft_matrix_device
    from repro_torch.kernels.dft_matmul import (dft_factored,
                                                dft_factored_cols,
                                                dft_factored_plain,
                                                dft_matmul, dft_matmul_cols,
                                                dft_matmul_cols_plain,
                                                dft_matmul_plain,
                                                factored_split)
    from repro_torch.kernels.ops import (dft_operand_device,
                                         factored_operands_device)
    _, _, w = dft_matrix_device(n_out, n_in, inverse, dev)
    ws = dft_operand_device(n_out, n_in, inverse, w.device)
    if L == 1:
        x = crandn(torch, gen, (M, n_in), dev)
        lines = x
        on_dense = on_dense_rows = lambda: dft_matmul(x, w, wsplit=ws)
        dense_plain = lambda: dft_matmul_plain(x, w)
    else:
        x = crandn(torch, gen, (M // L, n_in, L), dev)
        lines = x.transpose(1, 2).contiguous().view(M, n_in)
        on_dense = lambda: dft_matmul_cols(x, w, wsplit=ws)
        on_dense_rows = lambda: dft_matmul(lines, w, wsplit=ws)
        dense_plain = lambda: dft_matmul_cols_plain(x, w)
    if factored_split(n_in, n_out) is None:
        return on_dense, on_dense_rows, dense_plain, lines, w, None
    fo = factored_operands_device(n_out, n_in, bool(inverse), w.device)
    on_rows = lambda: dft_factored(lines, fo)
    kernel = on_rows if L == 1 else lambda: dft_factored_cols(x, fo)
    return (kernel, on_rows, lambda: dft_factored_plain(lines, fo), lines, w,
            on_dense)


#: kernel #1's stages in the benchmark's cells, one 128-band call each:
#: the paper pair's idft[x], idft[y], dft[Y], dft[X] and gw-mtxel's
#: dft[Y], dft[X] onto the 64-sphere, as (lines, n_in, n_out, inverse, L)
BENCH_LINE_STAGES = ((4194304, 128, 256, True, 32768),
                     (8388608, 128, 256, True, 65536),
                     (8388608, 256, 128, False, 1),
                     (4194304, 256, 128, False, 128),
                     (8388608, 256, 64, False, 1),
                     (2097152, 256, 64, False, 64))
#: lines on which the plain version of a factored stage is timed (its
#: complex64 intermediates at a whole stage would not fit beside it)
PLAIN_LINES = 1 << 20


def time_line_shapes(torch, dev, gen, stages: LineStages, gpu: str):
    """Kernel #1 at every distinct line shape the paths launched and at
    the benchmark's stages (``BENCH_LINE_STAGES``), through the entry each
    launch took: its time, both bounds, complex64 ``torch.matmul`` on the
    same lines; where that was the strided entry, the same mode's rows
    entry beside it on the same lines in rows, and the two checked bit for
    bit; where the stage is factored, the dense product through the same
    entry, the plain version (on ``PLAIN_LINES`` lines) and the kernel
    against it; where the stage copied its lines into rows (the "copied"
    route), that copy's time."""
    from repro_torch.obs.trace import relayout
    keys = sorted({k for c in stages.entries.values() for k in c}
                  | set(BENCH_LINE_STAGES),
                  key=lambda k: -k[0] * (k[1] + k[2]))
    print(f"kernel #1 by line shape and entry ({gpu}; CUDA events, mean of "
          "10):", flush=True)
    rows = []
    for key in keys:
        M, n_in, n_out, inverse, L = key
        kernel, on_rows, _, lines, w, dense = line_entry(
            torch, gen, dev, *key)
        ms = time_ms(torch, kernel)
        row = {"lines": M, "n_in": n_in, "n_out": n_out, "inverse": inverse,
               "entry": "strided" if L > 1 else "rows", "L": L,
               "mode": "dense" if dense is None else "factored",
               "launches": {p: c[key] for p, c in stages.entries.items()
                            if c[key]},
               "routes": sorted(stages.routes.get(key, ())), "ms": ms,
               "rows_ms": None, "bitwise": None, "dense_ms": None,
               "plain_ms": None, "plain_lines": None, "rel_err": None}
        if L > 1:
            row["rows_ms"] = time_ms(torch, on_rows)
            row["bitwise"] = bitwise(torch, kernel(), on_rows())
            check(row["bitwise"], f"kernel #1 {M}x{n_in}->{n_out}: the "
                  f"strided entry (L = {L}) gives the rows entry's bits")
        if dense is not None:
            from repro_torch.kernels.dft_matmul import (dft_factored,
                                                        dft_factored_plain)
            from repro_torch.kernels.ops import factored_operands_device
            row["dense_ms"] = time_ms(torch, dense)
            part = lines[:PLAIN_LINES]
            fo = factored_operands_device(n_out, n_in, bool(inverse),
                                          lines.device)
            row["plain_lines"] = part.shape[0]
            row["plain_ms"] = time_ms(
                torch, lambda: dft_factored_plain(part, fo), reps=3)
            _, row["rel_err"] = rel_err(torch, dft_factored(part, fo),
                                        dft_factored_plain(part, fo))
            check(row["rel_err"] <= FACTORED_RTOL,
                  f"kernel #1 {M}x{n_in}->{n_out} factored against its "
                  f"plain version: {row['rel_err']:.2e} <= {FACTORED_RTOL}")
            del part
        row["matmul_ms"] = time_ms(torch, lambda: torch.matmul(lines, w.T))
        del kernel, on_rows, lines, w, dense
        b = bound_ms(8.0 * (M * n_in + n_out * n_in + M * n_out),
                     8.0 * M * n_out * n_in)
        row.update(b)
        row["bytes_ms"] = 8.0 * M * (n_in + n_out) / HBM_BYTES_PER_S * 1e3
        row["bytes_share"] = row["bytes_ms"] / ms
        row["input"], row["copy_ms"] = None, None
        if key in stages.copies:
            shape, stride, perm = stages.copies[key]
            held = 1 + sum((n - 1) * st for n, st in zip(shape, stride))
            xs = crandn(torch, gen, (held,), dev).as_strided(shape, stride)
            row["input"], row["copy_ms"] = list(shape), time_ms(
                torch, lambda: relayout(xs.permute(*perm), n_in))
            del xs
        row["call_c_ms"] = CALL_C_MS.get(key[:4]) if L == 1 else None
        rows.append(row)
        copy_txt = ("" if row["copy_ms"] is None else
                    f"; copy {row['copy_ms']:.3f} ms of "
                    f"{tuple(row['input'])}")
        entry_txt = ("rows" if L == 1 else
                     f"strided L={L} (rows {row['rows_ms']:.3f} ms, "
                     f"{ms / row['rows_ms']:.3f}x; bitwise "
                     f"{row['bitwise']})")
        mode_txt = ("dense" if row["dense_ms"] is None else
                    f"factored (dense {row['dense_ms']:.3f} ms, plain "
                    f"{row['plain_ms']:.3f} ms on {row['plain_lines']} "
                    f"lines, rel err {row['rel_err']:.2e})")
        was = ("" if row["call_c_ms"] is None else
               f" ({ms / row['call_c_ms']:.3f}x call C's "
               f"{row['call_c_ms']:.3f} ms)")
        print(f"  {M}x{n_in}->{n_out}{' inv' if inverse else ''} "
              f"{entry_txt}, {mode_txt}: launches {row['launches']}, routes "
              f"{row['routes'] or 'not through local_dft'}, {ms:.3f} ms"
              f"{was}, bytes {row['bytes_ms']:.3f} ms "
              f"({100 * row['bytes_share']:.1f}%), {bound_text(b)}, "
              f"torch.matmul {row['matmul_ms']:.3f} ms{copy_txt}",
              flush=True)
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------ service
def service_requests(rng):
    """The service phase's requests, from the numpy generator ``rng``."""
    import numpy as np

    from repro_torch.core import kpoint_sphere
    diam = {"d": SERVICE_D, "d_small": SERVICE_D_SMALL}
    potentials = {}
    reqs = []
    for tenant, count, nbands, kpt, dkey, pot, deadline in SERVICE_TRACE:
        sphere = kpoint_sphere(diam[dkey], kpt)
        if pot and tenant not in potentials:
            potentials[tenant] = rng.standard_normal(
                (SERVICE_N,) * 3).astype(np.float32)
        for _ in range(count):
            c = (rng.standard_normal((nbands, sphere.npacked))
                 + 1j * rng.standard_normal((nbands, sphere.npacked))
                 ).astype(np.complex64)
            reqs.append({"tenant": tenant, "coeffs": c, "sphere": sphere,
                         "v_eff": potentials.get(tenant) if pot else None,
                         "deadline": deadline})
    return reqs


def make_service(dev, backend, grid=None):
    """The service phase's ``TransformService``: on one process, or on
    ``grid`` with its first axis as the batch axis (and then
    ``svc.pairs`` records the plan pairs it runs, :func:`watch_pairs`)."""
    from repro_torch.core import ProcGrid
    from repro_torch.serve import TransformService
    if grid is None:
        grid = ProcGrid.create([1], ["dft_f"], device=dev)
    svc = TransformService(
        grid, n=SERVICE_N, padding_budget=0.5, max_rows=SERVICE_MAX_ROWS,
        backend=backend, batch_axes=(0,) if grid.multi_process else ())
    if grid.multi_process:
        svc.pairs = watch_pairs(svc)
    return svc


def watch_pairs(svc) -> dict:
    """Record each plan pair ``svc`` builds or takes from its cache for a
    dispatch or a warm-up, once per row composition, in the order it ran
    them (on a grid, the same order on every rank):
    ``{(composition, bucket): (sphere extents, inverse, forward)}``."""
    from repro_torch.core.cache import domains_key
    pairs = {}
    pair_for = svc._pair_for

    def recorded(spheres, bucket):
        inv, fwd = pair_for(spheres, bucket)
        pairs.setdefault((domains_key(spheres), bucket),
                         (tuple(spheres[0].extents), inv, fwd))
        return inv, fwd
    svc._pair_for = recorded
    return pairs


def watch_padding(torch, svc) -> dict:
    """Check the padded lanes of every packed block that ``svc`` makes on
    this rank (every rank's rows, after the pack's all-reduce and the row
    gather): each must be exactly +0.0.  Returns the running tally."""
    tally = {"blocks": 0, "padded_lanes": 0, "plus_zero": True}
    run = svc._run_pair

    def watched(prepare):
        box = {}

        def prep():
            out = prepare()
            box["inv"] = out[0]
            return out
        packed = run(prep)
        pad = ~torch.as_tensor(box["inv"].valid_lanes(),
                               device=packed.device)
        tally["blocks"] += 1
        tally["padded_lanes"] += int(pad.sum())
        tally["plus_zero"] &= is_plus_zero(torch, packed[pad])
        return packed
    svc._run_pair = watched
    return tally


def serve_trace(dev, backend, reqs, grid=None):
    """Start a service, send the trace three times, stop it.

    The first (cold) pass pays the asynchronous plan builds and warm-up;
    the metrics window is then reset and the same trace sent again to the
    warm service, with the tracer recording its ``serve.dispatch`` spans
    (no extra synchronization: a dispatch ends in the result's host copy).
    A third pass records with the tracer's sync on, so each piece span
    inside a dispatch covers its own device work (the by-piece
    breakdown).  Returns the service and, per pass, its handles, each
    request's result (the output array, or the ``ServeError`` it failed
    with), the metrics summary, the dispatch spans' ms and, for the
    third pass, the pieces of each dispatch.  On a ``grid`` of several
    processes this is the front end's part (the other ranks follow with
    ``start``/``stop``).  ``svc.padding`` tallies the padded lanes of its
    packed blocks (:func:`watch_padding`).
    """
    import torch

    from repro_torch.obs import get_tracer
    from repro_torch.serve import ServeError
    svc = make_service(dev, backend, grid)
    svc.padding = watch_padding(torch, svc)
    tr = get_tracer()
    passes = []
    svc.start()
    try:
        for name in ("cold", "warm", "synced"):
            if name != "cold":
                svc.metrics.reset()
                tr.enable(sync=name == "synced", per_stage=False)
            handles = [svc.submit(r["tenant"], r["coeffs"], r["sphere"],
                                  v_eff=r["v_eff"], deadline=r["deadline"])
                       for r in reqs]
            results = []
            for h in handles:
                try:
                    results.append(h.result(timeout=300))
                except ServeError as err:
                    results.append(err)
            tr.disable()
            evs = tr.events()
            passes.append({"name": name, "handles": handles,
                           "results": results,
                           "summary": svc.metrics.summary(),
                           "dispatch_ms": [
                               round((e["t1"] - e["t0"]) * 1e3, 3)
                               for e in evs if e["name"] == "serve.dispatch"]
                           if name != "cold" else None,
                           "pieces": dispatch_pieces(evs)
                           if name == "synced" else None,
                           "batches": batch_compositions(handles, reqs)})
            tr.clear()
    finally:
        tr.disable()
        svc.stop(timeout=300)
    return svc, passes


def dispatch_pieces(events) -> list[dict]:
    """Per ``serve.dispatch`` span: its rows, bucket and ms, and the ms of
    each child span the service's ``_dispatch`` records (uploads, the
    fused unpack and inverse plan, ×v, the forward plan and fused pack,
    download; on several ranks also the sends and the row gather), in
    dispatch order."""
    out = []
    for d in sorted((e for e in events if e["name"] == "serve.dispatch"),
                    key=lambda e: e["t0"]):
        row = {"rows": d["attrs"]["rows"], "bucket": d["attrs"]["bucket"],
               "dispatch_ms": (d["t1"] - d["t0"]) * 1e3}
        pieces = {}
        for e in events:
            if (e["parent"] == "serve.dispatch" and e["tid"] == d["tid"]
                    and d["t0"] <= e["t0"] and e["t1"] <= d["t1"]):
                name = e["name"].removeprefix("serve.")
                pieces[f"{name}_ms"] = (e["t1"] - e["t0"]) * 1e3
        row.update(pieces)
        row["pieces_sum_ms"] = sum(pieces.values())
        out.append(row)
    return out


def print_pieces(what: str, rows) -> None:
    print(f"  {what}, each dispatch by piece (the service's own spans, "
          "ms, host clock, synchronized at each span's exit):", flush=True)
    for row in rows:
        print("    " + ", ".join(f"{k} {v:.1f}" if isinstance(v, float)
                                 else f"{k} {v}" for k, v in row.items()),
              flush=True)


def batch_compositions(handles, reqs) -> list[str]:
    """Each dispatched batch as ``tenant x bands + ...``, in dispatch
    order (a batch is the requests that share a ``dispatched_at``)."""
    batches: dict = {}
    for h, r in zip(handles, reqs):
        if h.dispatched_at is not None:
            batches.setdefault(h.dispatched_at, []).append(
                f"{r['tenant']}x{r['coeffs'].shape[0]}")
    return [" + ".join(b) for _, b in sorted(batches.items())]


def check_service(torch, dev, gpu, stages):
    """The service phase (see the module docstring); returns its record
    and the warm pass's results, which the multi-rank service is held
    against."""
    import numpy as np

    from repro_torch.kernels.dft_matmul import dft_matmul
    from repro_torch.kernels import sphere_pack
    from repro_torch.serve import DeadlineExceeded
    print(f"TransformService: n={SERVICE_N}, d={SERVICE_D} and "
          f"{SERVICE_D_SMALL}, max_rows={SERVICE_MAX_ROWS}, "
          "padding_budget=0.5, start() + async warming", flush=True)
    reqs = service_requests(np.random.default_rng(SEED + 2))
    print("  trace: " + ", ".join(
        f"{t}: {c}x{nb} bands d={SERVICE_D if k == 'd' else SERVICE_D_SMALL}"
        f" k={kp}{' +v_eff' if p else ''}"
        f"{f' deadline={dl}' if dl is not None else ''}"
        for t, c, nb, kp, k, p, dl in SERVICE_TRACE), flush=True)
    wrappers = (dft_matmul, sphere_pack.unpack_dft, sphere_pack.dft_pack)
    for fn in wrappers:
        fn.launches = 0
    t0 = time.perf_counter()
    with stages.record("service") as shapes:
        svc, passes = serve_trace(dev, "cuda", reqs)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in wrappers}
    check(sum(shapes.values()) == launches["dft_matmul"],
          "the recorded line shapes cover every dft_matmul launch of the "
          "cuda service")
    cold, warm, synced = passes
    for p in passes:
        print(f"  service metrics, {p['name']} pass ({gpu}): "
              + json.dumps(p["summary"]), flush=True)
    for p in passes:
        print(f"  {p['name']} pass batches: {p['batches']}", flush=True)
    print(f"  warm pass: serve.dispatch spans {warm['dispatch_ms']} ms",
          flush=True)
    print_pieces("synced pass", synced["pieces"])
    print(f"  wall {wall:.3f} s for three passes of {len(reqs)} requests "
          f"(plan builds and warming included); launches {launches}",
          flush=True)
    check(launches["dft_matmul"] > 0,
          f"dft_matmul launched {launches['dft_matmul']} times in the "
          "cuda service")
    check(launches["unpack_dft"] > 0 and launches["dft_pack"] > 0,
          "the service's dispatches ran the fused sphere kernels #3, #4")
    check(svc.padding["plus_zero"] and svc.padding["padded_lanes"] > 0,
          f"the {svc.padding['padded_lanes']} padded lanes of its "
          f"{svc.padding['blocks']} packed blocks are exactly +0.0")

    ok = [i for i, r in enumerate(reqs) if r["deadline"] is None]
    late = [i for i, r in enumerate(reqs) if r["deadline"] is not None]
    summary = cold["summary"]
    check(summary["dispatches"] < len(reqs)
          and summary["coalesced_dispatches"] >= 1,
          f"requests coalesced: {summary['dispatches']} dispatches for "
          f"{len(reqs)} requests")
    pieces = synced["pieces"]
    check(len(pieces) == synced["summary"]["dispatches"] and all(
        SERVICE_PIECES <= row.keys()
        and row["pieces_sum_ms"] <= row["dispatch_ms"] for row in pieces),
          f"synced pass: {len(pieces)} dispatches, each with its piece "
          "spans, nested inside it")
    errs = {"eager": 0.0, "matmul": 0.0, "round_trip": 0.0}
    for p in passes:
        name, results = p["name"], p["results"]
        check(all(isinstance(results[i], DeadlineExceeded) for i in late),
              f"{name}: {len(late)} deadline=0.0 request(s) failed with "
              "DeadlineExceeded")
        check(all(isinstance(results[i], np.ndarray) for i in ok),
              f"{name}: {len(ok)} requests resolved with results")
        pad = p["summary"]["padding_fraction_max"]
        check(pad <= 0.5, f"{name}: padding_fraction_max {pad} <= 0.5")
        batches: dict = {}
        for i in ok:
            batches.setdefault(p["handles"][i].dispatched_at, set()).add(
                reqs[i]["sphere"].extents)
        check(all(len(ext) == 1 for ext in batches.values()),
              f"{name}: {len(batches)} batches, none mixes d={SERVICE_D} "
              f"and d={SERVICE_D_SMALL} rows")
        for i in ok:
            r = reqs[i]
            _, rel = rel_err(np, results[i], svc.eager_apply(
                r["coeffs"], r["sphere"], r["v_eff"]))
            errs["eager"] = max(errs["eager"], rel)
            if r["v_eff"] is None:
                _, rel = rel_err(np, results[i], r["coeffs"])
                errs["round_trip"] = max(errs["round_trip"], rel)
    check(errs["eager"] <= KERNEL_RTOL, f"every result vs eager_apply: "
          f"max rel err {errs['eager']:.3e} <= {KERNEL_RTOL:g}")
    check(errs["round_trip"] <= KERNEL_RTOL, "gamma round trips return "
          f"their input: max rel err {errs['round_trip']:.3e}")

    tracer = trace_eager_apply(torch, dev, svc, reqs[ok[0]])

    before = dft_matmul.launches
    m_svc, m_passes = serve_trace(dev, "matmul", reqs)
    check(dft_matmul.launches == before,
          "dft_matmul never launched in the matmul service")
    for p, mp in zip(passes, m_passes):
        for i in ok:
            _, rel = rel_err(np, p["results"][i], mp["results"][i])
            errs["matmul"] = max(errs["matmul"], rel)
    check(errs["matmul"] <= KERNEL_RTOL, f"every result vs the matmul "
          f"service: max rel err {errs['matmul']:.3e} <= {KERNEL_RTOL:g}")
    for mp in m_passes:
        print(f"  matmul service metrics, {mp['name']} pass: "
              + json.dumps(mp["summary"]), flush=True)
    print(f"  matmul warm pass: serve.dispatch spans "
          f"{m_passes[1]['dispatch_ms']} ms", flush=True)
    print_pieces("matmul synced pass", m_passes[2]["pieces"])
    return {"cold": summary, "warm": warm["summary"],
            "warm_dispatch_ms": warm["dispatch_ms"],
            "matmul_cold": m_passes[0]["summary"],
            "matmul_warm": m_passes[1]["summary"],
            "matmul_warm_dispatch_ms": m_passes[1]["dispatch_ms"],
            "wall_s": wall, "launches": launches, "max_rel_err": errs,
            "padding": svc.padding, "tracer": tracer,
            "synced_dispatch_pieces": pieces,
            "matmul_synced_dispatch_pieces": m_passes[2]["pieces"]}, \
        warm["results"]


def trace_eager_apply(torch, dev, svc, req):
    """The port's tracer around one ``eager_apply``: its stage spans must
    be the plans' stages, in order, each covering its stage's device time
    (a span is synchronized with the card at exit)."""
    import tempfile

    from repro_torch.core import Domain, fftb
    from repro_torch.core.plan import FFTStage
    from repro_torch.obs import get_tracer
    bdom = Domain((0,), (req["coeffs"].shape[0] - 1,))
    inv = fftb.plan_for(svc._pw_spec, domains=(bdom, req["sphere"]),
                        grid=svc.grid, sizes=(svc.n,) * 3, inverse=True,
                        backend=svc.backend, cache=svc.cache)
    fwd = inv.inverse()
    stages = list(inv.stages) + list(fwd.stages)
    want = [("idft" if st.inverse else "dft") + f"[{st.dim}] "
            f"{st.n_in}->{st.n_out}" if isinstance(st, FFTStage)
            else f"a2a[{st.axis_name}] {st.src}->{st.dst}" for st in stages]
    tr = get_tracer().enable(sync=True, per_stage=True)
    try:
        svc.eager_apply(req["coeffs"], req["sphere"], req["v_eff"])
    finally:
        tr.disable()
    evs = sorted((e for e in tr.events()
                  if (e["parent"] or "").startswith("plan:")),
                 key=lambda e: e["t0"])
    names = [e["name"] for e in evs]
    check(names == want, f"{len(names)} stage spans match the plans' "
          f"stages: {names}")
    # each stage again, alone, on the same inputs: its mean device time
    # over back-to-back calls between CUDA events (one call alone also
    # times the host's launch of the stage's first kernel, with the card
    # idle meanwhile), the least of three such means: a host stall inside
    # one window leaves the card idle there and counts as device time
    c = torch.as_tensor(req["coeffs"], device=dev)
    x = inv.unpack(c)
    dev_ms = []
    for i, st in enumerate(stages):
        if i == len(inv.stages) and req["v_eff"] is not None:
            x = x * torch.as_tensor(req["v_eff"], device=dev)
        dev_ms.append(min(time_ms(torch, lambda st=st, x=x: st.apply(x),
                                  reps=5) for _ in range(3)))
        x = st.apply(x)
    span_ms = [(e["t1"] - e["t0"]) * 1e3 for e in evs]
    # line-DFT stages only: a move over a one-process axis does no work
    cover = [s / d for s, d, st in zip(span_ms, dev_ms, stages)
             if isinstance(st, FFTStage)]
    print("  stage spans (ms, host clock) vs CUDA events (ms): " + ", ".join(
        f"{n} {s:.3f}/{d:.3f}" for n, s, d in zip(names, span_ms, dev_ms)),
        flush=True)
    check(min(cover) >= SPAN_COVERAGE, f"every line-DFT stage span "
          f"covers >= {SPAN_COVERAGE:g} of its stage's device time (min "
          f"{min(cover):.3f}): span exit synchronized the card")
    with tempfile.TemporaryDirectory() as tmp:
        path = tr.export_chrome(os.path.join(tmp, "eager_apply.json"))
        with open(path) as f:
            nev = sum(1 for e in json.load(f)["traceEvents"]
                      if e["ph"] == "X")
    check(nev == len(tr.events()), f"Chrome trace exported: {nev} events")
    tr.clear()
    return {"stages": names, "span_ms": span_ms, "event_ms": dev_ms,
            "min_coverage": min(cover)}


# ---------------------------------------------------------------------- SCF
def run_slice(torch, dev, stages):
    import numpy as np

    from repro_torch.dft import run_scf
    from repro_torch.dft.basis import PlaneWaveBasis
    from repro_torch.dft.hamiltonian import orthonormalize
    from repro_torch.kernels import sphere_pack
    from repro_torch.kernels.dft_matmul import dft_matmul

    print(f"SCF: n={N} d={DIAMETER} nbands={NBANDS} kpts={KPTS} "
          f"stack_k=True max_iter={MAX_ITER}", flush=True)
    print("reduced: " + json.dumps(REDUCED), flush=True)
    basis = PlaneWaveBasis(N, diameter=DIAMETER, kpts=KPTS, nbands=NBANDS,
                           device=dev)
    rng = np.random.default_rng(SEED)
    coeffs = []
    for ik in range(basis.nk):
        npk = basis.npacked(ik)
        c = (rng.standard_normal((NBANDS, npk))
             + 1j * rng.standard_normal((NBANDS, npk))).astype(np.complex64)
        coeffs.append(orthonormalize(torch.as_tensor(c, device=dev)))
    print(f"  stacked batch B={basis.nk * NBANDS}, npacked_max="
          f"{basis.npacked_max}", flush=True)

    cfg = scf_config
    wrappers = (dft_matmul, sphere_pack.unpack_dft, sphere_pack.dft_pack)
    for fn in wrappers:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    with stages.record("scf") as shapes:
        res_k_stamps = Stamps()
        res_k = run_scf(cfg("cuda"), device=dev, coeffs=coeffs,
                        callback=res_k_stamps)
    peak_k = torch.cuda.max_memory_allocated(dev)
    res_k.stamps = res_k_stamps
    launches = {fn.__name__: fn.launches for fn in wrappers}
    check(sum(shapes.values()) == launches["dft_matmul"],
          f"the {len(shapes)} recorded line shapes cover every dft_matmul "
          "launch of the SCF")
    res_m = run_scf(cfg("matmul"), device=dev, coeffs=coeffs)
    after = {fn.__name__: fn.launches for fn in wrappers}
    print(f"  kernel launches on the cuda route: {launches}", flush=True)
    for name, k in launches.items():
        check(k > 0, f"{name} launched {k} times on the cuda route")
        check(after[name] == k, f"{name} never launched on the matmul "
              "route")
    check(res_k.stacked and res_k.backend == "cuda"
          and res_m.backend == "matmul", "both runs rode the stacked route")
    for res in (res_k, res_m):
        per_it = [round(r["seconds"], 3) for r in res.iteration_records]
        print(f"  {res.backend:6s}: energies {res.energies}, "
              f"{res.seconds_per_iteration:.3f} s/iteration "
              f"(per-iteration records {per_it}, which leave out the "
              "host mixing)", flush=True)
    steady_k = iteration_times(res_k)
    print(f"  cuda route, wall time between iteration ends (mixing "
          f"included): {[round(x, 4) for x in steady_k['steady_wall_s']]} "
          f"s", flush=True)
    ek, em = np.asarray(res_k.energies), np.asarray(res_m.energies)
    de = float(np.abs(ek - em).max())
    check(len(ek) == len(em) == MAX_ITER and np.isfinite(ek).all(),
          f"{MAX_ITER} finite energies per route")
    check(de <= ENERGY_RTOL * max(1.0, float(np.abs(em).max())),
          f"energies agree: max |dE| {de:.3e} <= {ENERGY_RTOL:g}·max(1,|E|)")
    deig = float(np.abs(res_k.eigenvalues - res_m.eigenvalues).max())
    check(res_k.eigenvalues.shape == (len(KPTS), NBANDS)
          and bool(np.all(np.diff(res_k.eigenvalues, axis=1) >= -1e-6)),
          "eigenvalues (nk, nbands), ascending per k")
    check(deig <= EIG_ATOL * max(1.0, float(np.abs(res_m.eigenvalues).max())),
          f"eigenvalues agree: max diff {deig:.3e} <= {EIG_ATOL:g}")
    drho = float((res_k.rho - res_m.rho).abs().max())
    rmax = float(res_m.rho.abs().max())
    check(tuple(res_k.rho.shape) == (N, N, N)
          and bool(torch.isfinite(res_k.rho).all()),
          f"rho is a finite ({N},{N},{N}) field")
    check(drho <= RHO_RTOL * rmax,
          f"rho agrees: max diff {drho:.3e} <= {RHO_RTOL:g}·{rmax:.3e}")
    print(f"  cuda route: peak memory {peak_k / 2**30:.2f} GiB", flush=True)
    return launches, {"cuda_s_per_iteration": res_k.seconds_per_iteration,
                      "cuda_steady_wall_s": steady_k["steady_s"],
                      "cuda_peak_gib": peak_k / 2**30,
                      "matmul_s_per_iteration": res_m.seconds_per_iteration,
                      "energy_cuda": res_k.energy,
                      "energy_matmul": res_m.energy, "max_dE": de,
                      "max_deig": deig, "max_drho": drho}, \
        {"coeffs": coeffs, "cuda": res_k}


def scf_config(backend, **kw):
    """The smoke SCF's configuration; mix_warmup >= max_iter: a fixed
    (linearly mixed) trajectory, no early stop."""
    from repro_torch.dft import SCFConfig
    return SCFConfig(**{"n": N, "diameter": DIAMETER, "nbands": NBANDS,
                        "kpts": KPTS, "stack_k": True, "backend": backend,
                        "max_iter": MAX_ITER, "mix_warmup": MAX_ITER, **kw})


def agreement(torch, res, ref, what: str) -> dict:
    """Hold an SCF run against a reference run of the same trajectory to
    PERF.md's limits: energies rel. 1e-4, eigenvalues abs. 1e-4, ρ 1e-3 of
    max ρ."""
    import numpy as np
    e, er = np.asarray(res.energies), np.asarray(ref.energies)
    check(len(e) == len(er) and bool(np.isfinite(e).all()),
          f"{what}: {len(e)} finite energies")
    de = float(np.abs(e - er).max())
    deig = float(np.abs(res.eigenvalues - ref.eigenvalues).max())
    drho = float((res.rho - ref.rho).abs().max())
    rmax = float(ref.rho.abs().max())
    check(de <= ENERGY_RTOL * max(1.0, float(np.abs(er).max())),
          f"{what}: energies agree, max |dE| {de:.3e}")
    check(bool(np.all(np.diff(res.eigenvalues, axis=1) >= -1e-6))
          and deig <= EIG_ATOL * max(1.0, float(
              np.abs(ref.eigenvalues).max())),
          f"{what}: eigenvalues ascending and agree, max diff {deig:.3e}")
    check(tuple(res.rho.shape) == (N, N, N)
          and bool(torch.isfinite(res.rho).all())
          and drho <= RHO_RTOL * rmax,
          f"{what}: rho finite and agrees, max diff {drho:.3e} <= "
          f"{RHO_RTOL:g}·{rmax:.3e}")
    return {"max_dE": de, "max_deig": deig, "max_drho": drho}


class Stamps:
    """An SCF callback keeping the host clock at the end of every
    iteration (after its host read of energy and residual)."""

    def __init__(self, then=None):
        self.t: list[float] = []
        self.then = then

    def __call__(self, it, energy, resid):
        self.t.append(time.perf_counter())
        if self.then is not None:
            self.then(it, energy, resid)


def iteration_times(res) -> dict:
    """Seconds per iteration, two ways.  ``first_s``/``record_s``: the
    run's own per-iteration records, which time each iteration's body
    only (the eager loop mixes after the record is taken).  ``steady_s``:
    the wall time between the ends of consecutive iterations (the
    callback's host clock), the mixing included: what a user waits per
    iteration, the same for every route."""
    secs = [r["seconds"] for r in res.iteration_records]
    t = res.stamps.t
    walls = [b - a for a, b in zip(t, t[1:])]
    return {"first_s": secs[0], "steady_s": sum(walls) / len(walls),
            "steady_wall_s": walls, "record_s": secs}


# ------------------------------------------------- executor modes, lazy SCF
def check_exec_modes(torch, dev, gen):
    """The stacked SCF's inverse plan (B=32, d=128 → n=256) on the "cuda"
    backend under the eager executor and the lazy one in fp32 and bf16:
    CUDA-event times, error against the eager result's largest value, peak
    memory; then ``tune()`` of a fresh copy of that plan."""
    from repro_torch.core import fftb
    from repro_torch.core.policy import ExecPolicy
    from repro_torch.dft.basis import PlaneWaveBasis
    b = PlaneWaveBasis(N, diameter=DIAMETER, kpts=KPTS, nbands=NBANDS,
                       backend="cuda", device=dev)
    plan = b.stacked_inverse_plan()
    print(f"executor modes at the stacked SCF's inverse plan "
          f"{plan.tin.shape} -> {plan.tout.shape} (backend cuda):",
          flush=True)
    x = crandn(torch, gen, plan.tin.shape, dev)
    ref = plan(x)
    scale = float(ref.abs().max())
    out = {}
    for name, tol in (("eager", 0.0), ("lazy", 1e-5), ("lazy_bf16", 3e-2)):
        pol = ExecPolicy.from_mode(name)
        y = plan(x, policy=pol)
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        del y
        y = plan(x, policy=pol)
        torch.cuda.synchronize(dev)
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        rel = float((y - ref).abs().max()) / scale
        del y
        ms = time_ms(torch, lambda pol=pol: plan(x, policy=pol), reps=5)
        out[name] = {"ms": ms, "rel_err": rel, "peak_gib": peak}
        print(f"  {name:9s}: {ms:.3f} ms, rel err {rel:.3e} of the eager "
              f"result's largest value, peak {peak:.2f} GiB above the "
              "input, the eager result and the output", flush=True)
        if tol:
            check(rel <= tol, f"{name} agrees with eager within {tol:g}")
    del ref
    # a plan of its own: tune() pins its winner on the plan it tunes
    fresh = fftb(b._pw_spec, domains=plan.tin.domains, grid=b.grid,
                 sizes=(N,) * 3, inverse=True, backend="cuda")
    best = fresh.tune(x)
    out["tune"] = {"seconds": fresh.tune_seconds,
                   "winner": best.legacy_mode}
    print("  tune(): " + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in
                                   fresh.tune_seconds.items())
          + f" per call (host clock, synchronized); winner "
          f"{best.legacy_mode}", flush=True)
    check(fresh.policy == best and best.legacy_mode in fresh.tune_seconds,
          "tune() pinned its winner on the plan")
    del x
    return out


def run_lazy_scf(torch, dev, ctx):
    """The smoke SCF under ``ExecPolicy(mode="lazy")`` on "cuda", against
    the eager "cuda" run of the same trajectory.  The fused sphere
    kernels still unpack and pack; every other stage is a lazy GEMM, so
    kernel #1 does not launch."""
    from repro_torch.core.policy import ExecPolicy
    from repro_torch.dft import run_scf
    from repro_torch.kernels import sphere_pack
    from repro_torch.kernels.dft_matmul import dft_matmul
    wrappers = (dft_matmul, sphere_pack.unpack_dft, sphere_pack.dft_pack)
    for fn in wrappers:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    stamps = Stamps()
    res = run_scf(scf_config("cuda", policy=ExecPolicy(mode="lazy")),
                  device=dev, coeffs=ctx["coeffs"], callback=stamps)
    res.stamps = stamps
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    launches = {fn.__name__: fn.launches for fn in wrappers}
    print(f"SCF, lazy fp32 executor (cuda backend): launches {launches}",
          flush=True)
    check(launches["unpack_dft"] > 0 and launches["dft_pack"] > 0
          and launches["dft_matmul"] == 0,
          "the lazy route ran the sphere kernels and no line-DFT kernel")
    agree = agreement(torch, res, ctx["cuda"], "lazy vs eager cuda")
    t = iteration_times(res)
    print(f"  lazy: first iteration {t['first_s']:.3f} s, steady "
          f"{t['steady_s']:.3f} s/iteration, wall between iteration ends "
          f"(eager cuda: {iteration_times(ctx['cuda'])['steady_s']:.3f}), "
          f"peak {peak:.2f} GiB", flush=True)
    return {**t, **agree, "peak_gib": peak, "launches": launches,
            "energies": res.energies}


# ---------------------------------------------------------- fused SCF step
def run_fused_step(torch, dev, ctx):
    """The smoke SCF with ``jit_step=True`` on "cuda": the step captured as
    CUDA graphs and replayed.

    Once with linear mixing (``mix_history=1``) against an eager run with
    the same settings; once with the default Anderson mixer (device DIIS),
    whose mixing replaces the eager loop's host mixer.  Launch counts:
    the wrappers count a launch when their Python runs, which the fused
    step does twice (the warm-up and the capture) and the replays never;
    each captured launch is counted once, as half the run's count, and
    the counts must not grow with the iterations.  Host syncs per steady
    iteration are counted by ``torch.cuda.set_sync_debug_mode("warn")``
    over one replayed iteration, between two callbacks.
    """
    import warnings

    import numpy as np

    from repro_torch.core import FftPlan
    from repro_torch.dft import run_scf
    from repro_torch.dft.scf import jit_mix, jit_mixer_init
    from repro_torch.kernels import sphere_pack
    from repro_torch.kernels.dft_matmul import dft_matmul
    from repro_torch.obs import get_tracer
    wrappers = (dft_matmul, sphere_pack.unpack_dft, sphere_pack.dft_pack)
    tr = get_tracer()

    stamps = Stamps()
    eager = run_scf(scf_config("cuda", mix_history=1), device=dev,
                    coeffs=ctx["coeffs"], callback=stamps)
    eager.stamps = stamps
    out = {"eager_linear": iteration_times(eager)}
    print(f"SCF, eager loop with linear mixing on the device: steady "
          f"{out['eager_linear']['steady_s']:.3f} s/iteration (wall between "
          "iteration ends)", flush=True)
    graphs_mod = sys.modules["repro_torch.dft.graphs"]
    capture = graphs_mod.StepGraphs.capture
    torch.cuda.empty_cache()
    for name, kw in (("linear", {"mix_history": 1}),
                     ("anderson", {"mix_warmup": 2})):
        for fn in wrappers:
            fn.launches = 0
        marks = []
        syncs = {}
        captured = {}

        def counted_capture(self, fn, *args):
            # the launches inside the capture, each counted once: the
            # replays re-issue them without running the wrappers
            before = {f.__name__: f.launches for f in wrappers}
            res = capture(self, fn, *args)
            captured.update({f.__name__: f.launches - before[f.__name__]
                             for f in wrappers})
            return res

        def callback(it, energy, resid, marks=marks):
            marks.append((FftPlan.executions,
                          {f.__name__: f.launches for f in wrappers}))
            # iteration 1: count its host syncs; iteration 2: trace it
            # (the graph and host-sync spans of StepGraphs.replay)
            if it == 0:
                torch.cuda.set_sync_debug_mode("warn")
                syncs["start"] = len(caught)
            elif it == 1:
                torch.cuda.set_sync_debug_mode(0)
                syncs["end"] = len(caught)
                tr.clear()
                tr.enable(sync=True, per_stage=False)
            elif it == 2:
                tr.disable()
        stamps = Stamps(callback)
        torch.cuda.reset_peak_memory_stats(dev)
        graphs_mod.StepGraphs.capture = counted_capture
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                res = run_scf(scf_config("cuda", jit_step=True, **kw),
                              device=dev, coeffs=ctx["coeffs"],
                              callback=stamps)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                graphs_mod.StepGraphs.capture = capture
        res.stamps = stamps
        tr.disable()
        pieces = [{"name": e["name"] if e["name"] != "step_graph" else
                   f"graph[{e['attrs']['index']}]",
                   "ms": (e["t1"] - e["t0"]) * 1e3} for e in tr.events()
                  if e["name"] == "step_graph"
                  or e["name"].startswith("host_sync:")]
        tr.clear()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        found = [str(w.message) for w in caught[syncs["start"]:syncs["end"]]
                 if "synchroniz" in str(w.message)
                 and "prototype" not in str(w.message)]
        st = res.graphs
        t = iteration_times(res)
        steady_execs = marks[-1][0] - marks[0][0]
        steady_launches = {k: marks[-1][1][k] - marks[0][1][k]
                           for k in captured}
        print(f"SCF, fused step ({name} mixing, cuda backend): jitted "
              f"{res.jitted}, {st['graphs']} graphs per iteration, "
              f"{st['replays']} replays of the step ({st['graphs']} graph "
              f"launches and {len(st['host_syncs'])} host syncs each), "
              f"capture {st['capture_seconds']:.3f} s", flush=True)
        print(f"  first iteration (warm-up + capture) {t['first_s']:.3f} s, "
              f"steady {t['steady_s']:.3f} s/iteration (wall between "
              f"iteration ends {[round(x, 4) for x in t['steady_wall_s']]}),"
              f" peak {peak:.2f} GiB", flush=True)
        print("  one steady iteration by piece (traced, synchronized "
              "spans, ms): " + ", ".join(f"{p['name']} {p['ms']:.1f}"
                                         for p in pieces), flush=True)
        print(f"  host syncs in one steady iteration: {len(found)} seen by "
              f"the sync debug mode; named: {st['host_syncs']} between the "
              "graphs, plus the energy/residual read", flush=True)
        print(f"  kernel launches captured (each counted once; the replays "
              f"re-issue them): {captured}; wrapper launches over the "
              f"steady iterations: {steady_launches}; FftPlan.executions "
              f"over the steady iterations: {steady_execs}", flush=True)
        check(res.jitted and st["replays"] == MAX_ITER - 1,
              f"{name}: {MAX_ITER - 1} steady iterations replayed the graphs")
        check(steady_execs == 0,
              f"{name}: the steady iterations ran no plan call")
        check(all(v > 0 for v in captured.values())
              and not any(steady_launches.values()),
              f"{name}: every kernel of the path was captured, and the "
              "replays ran no wrapper")
        check(len(found) == len(st["host_syncs"]) + 1,
              f"{name}: {len(found)} host syncs per steady iteration = the "
              f"{len(st['host_syncs'])} named ones + the energy/residual "
              "read")
        rec = {**t, "peak_gib": peak, "graphs": st["graphs"],
               "replays": st["replays"], "host_syncs": st["host_syncs"],
               "syncs_seen": len(found), "pieces": pieces,
               "capture_s": st["capture_seconds"],
               "captured_launches": captured,
               "steady_plan_executions": steady_execs,
               "energies": res.energies}
        if name == "linear":
            rec.update(agreement(torch, res, eager,
                                 "fused step vs eager, linear mixing"))
            # the multi-rank fused step is held against this run
            ctx["fused_linear"] = res
        else:
            check(bool(np.isfinite(res.energies).all())
                  and bool(np.all(np.diff(res.eigenvalues, axis=1)
                                  >= -1e-6)),
                  "anderson: finite energies, ascending eigenvalues")
        out[name] = rec
        del res
        torch.cuda.empty_cache()
    # the device mixer alone at n=256, history 5, its DIIS solve active
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rho = torch.rand((N, N, N), generator=gen, device=dev)
    state = jit_mixer_init(N ** 3, 5, dev)
    for _ in range(5):
        jit_mix(state, rho, rho * 1.01 + 0.001, alpha=0.7, warmup=0)
    out["mix_ms"] = time_ms(torch, lambda: jit_mix(
        state, rho, rho * 1.01 + 0.001, alpha=0.7, warmup=0), reps=5)
    print(f"  device Anderson mix alone (n={N}, history 5): "
          f"{out['mix_ms']:.3f} ms (CUDA events)", flush=True)
    del state, rho
    return out


# ------------------------------------------------------------- multi-rank
#: the multi-rank phase.  One card takes the ranks as processes that share
#: it over gloo (NCCL takes one card per rank): gloo copies CUDA tensors
#: through host memory, so its times show what local shard shapes cost
#: per rank, and no scaling.  First the smoke SCF's widths on the 2×2
#: batch×fft grid, MR_ITERS iterations eager and fused, each against one
#: rank's run of as many (MAX_ITER until Granite-MoE's (1, 16) run came:
#: the third iteration of each took ~26 s of the script's time and ran
#: no other code), then the chooser's (2, 2, 2) pencil grid at the
#: reference's own n = 16 (tests/test_dft.py).
MR_PROCS, MR_GRID, MR_AXES = 4, (2, 2), ("dft_b", "dft_f")
MR_ITERS, MR_TIMEOUT, MR_THREADS = 2, 600.0, 2
PENCIL_PROCS, PENCIL_N, PENCIL_NBANDS = 8, 16, 4
MR_TAG = "4 processes on one card, gloo"


def _gib(x) -> str:
    return "not measured" if x is None else f"{x:.2f} GiB"


def _kernel_entry(torch, shape, kernel, plain, got=None, timed=True):
    """One kernel call against its plain version on the same inputs, with
    both timed (CUDA events) when ``timed``."""
    got = kernel() if got is None else got
    err, rel = rel_err(torch, got, plain())
    return {"shape": shape, "max_abs_err": err, "rel_err": rel,
            "ms": time_ms(torch, kernel) if timed else None,
            "plain_ms": time_ms(torch, plain, reps=3) if timed else None}


def pair_kernel_checks(torch, dev, inv, fwd, rows, v, rank, world,
                       timed=True):
    """Kernels #3 and #4 of one plan pair against their plain versions on
    a rank's own inputs: #3 on its ``rows`` with the fused route's sliced
    line tables, flag and chunk ranges; #4 in its ``partial`` mode on the
    slab that the forward lead plan leaves from those rows times ``v``
    (its lanes outside the rank's lines must be +0.0).  Every rank runs
    the plans' all-to-alls first; then ranks take turns (a barrier between
    them), so each one's CUDA-event times are its own."""
    import torch.distributed as dist

    from repro_torch.kernels import sphere_pack as sp
    timed = timed and dev.type == "cuda"
    ip, fp = inv._fused_in_parts(), fwd._fused_out_parts()
    ustart, uzlo, ucnt, flag, chunks = ip["private"]

    def unpack():
        return sp.unpack_dft(rows, ustart, uzlo, ucnt, flag, ip["w"],
                             chunks=chunks, wsplit=ip["wsplit"])
    mid = unpack()
    # the plans' other stages hold the all-to-alls: every rank runs them
    slab = fp["lead"](ip["rem"](mid) * v)
    start, zlo, cnt, nvalid = fp["private"]
    npk, w = fp["out_shape"][1], fp["w"]

    def pack():
        return sp.dft_pack(slab, start, zlo, cnt, nvalid, w, npk,
                           wsplit=fp["wsplit"], partial=fp["partial"])
    out = {}
    for turn in range(world):
        dist.barrier()
        if turn != rank:
            continue
        out["unpack_dft"] = _kernel_entry(
            torch, f"{tuple(rows.shape)}->{tuple(mid.shape)}", unpack,
            lambda: sp.unpack_dft_plain(rows, ustart, uzlo, ucnt, flag,
                                        ip["w"]), mid, timed)
        got = pack()
        out["dft_pack"] = _kernel_entry(
            torch, f"{tuple(slab.shape)}->{tuple(got.shape)}", pack,
            lambda: sp.dft_pack_plain(slab, start, zlo, cnt, nvalid, w,
                                      npk), got, timed)
        # the lanes the rank's lines do not cover: other ranks' x planes
        # and padding, each written +0.0 for the all-reduce
        z = torch.arange(w.shape[0], device=dev)
        lane = start.long()[..., None] + z
        inside = z < cnt.long()[..., None]
        rr = torch.arange(got.shape[0], device=dev)[:, None, None]
        mine = torch.zeros(got.shape, dtype=torch.bool, device=dev)
        mine[rr.expand_as(lane)[inside], lane[inside]] = True
        out["dft_pack"].update(partial=fp["partial"],
                               other_lanes=int((~mine).sum()),
                               other_lanes_plus_zero=is_plus_zero(
                                   torch, got[~mine]))
        del got, mine
    del mid, slab
    dist.barrier()
    return out


def line_kernel_checks(torch, dev, lines, rank, world):
    """Kernel #1 against its plain version at each line shape in
    ``lines`` (the rank's launches by ``(lines, n_in, n_out, inverse, L)``,
    :meth:`LineStages.launched`), through the entry each took (the strided
    one where L > 1), ranks taking turns as in :func:`pair_kernel_checks`."""
    import torch.distributed as dist
    gen = torch.Generator(device=dev).manual_seed(SEED + rank)
    out = []
    for turn in range(world):
        dist.barrier()
        if turn != rank:
            continue
        for M, n_in, n_out, inverse, L in lines:
            kernel, _, plain, _, _, _ = line_entry(torch, gen, dev, M,
                                                   n_in, n_out, inverse, L)
            out.append(_kernel_entry(
                torch, f"{M}x{n_in}->{n_out}{' inv' if inverse else ''}"
                + (f" strided L={L}" if L > 1 else ""), kernel, plain,
                timed=dev.type == "cuda"))
            del kernel, plain
    dist.barrier()
    return out


def rank_kernel_checks(torch, dev, basis, c_pad, v, lines, rank, world):
    """Each kernel of a rank's H apply and SCF against its plain version
    on the rank's own inputs: #3 and #4 on the stacked Hamiltonian pair
    (:func:`pair_kernel_checks`, its rows of ``c_pad``), #1 at each line
    shape in ``lines`` (:func:`line_kernel_checks`)."""
    inv, fwd = basis.stacked_hamiltonian_plans()
    rows = inv.local_rows(c_pad.reshape(-1, c_pad.shape[-1])).contiguous()
    out = pair_kernel_checks(torch, dev, inv, fwd, rows, v, rank, world)
    out["dft_matmul"] = line_kernel_checks(torch, dev, lines, rank, world)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def check_pair_kernels(what, k) -> None:
    """The parent's checks of one :func:`pair_kernel_checks` result."""
    for name in ("unpack_dft", "dft_pack"):
        check(k[name]["rel_err"] <= KERNEL_RTOL,
              f"{what}: {name} at {k[name]['shape']} vs its plain "
              f"version, rel err {k[name]['rel_err']:.2e} <= "
              f"{KERNEL_RTOL:g}")
    p = k["dft_pack"]
    check(p["partial"] and p["other_lanes"] > 0
          and p["other_lanes_plus_zero"],
          f"{what}: dft_pack(partial=True) wrote its {p['other_lanes']} "
          "lanes of other x planes and padding +0.0")


def check_line_kernels(what, lines) -> None:
    """The parent's checks of one :func:`line_kernel_checks` result."""
    check(len(lines) > 0, f"{what}: kernel #1 launched")
    for k in lines:
        check(k["rel_err"] <= KERNEL_RTOL,
              f"{what}: dft_matmul at {k['shape']} vs its plain "
              f"version, rel err {k['rel_err']:.2e} <= {KERNEL_RTOL:g}")


def check_rank_kernels(r, what, kc) -> None:
    """The parent's checks of one rank's :func:`rank_kernel_checks`."""
    check_pair_kernels(f"{what} rank {r}", kc)
    check_line_kernels(f"{what} rank {r}", kc["dft_matmul"])


def print_service_kernels(r, kc) -> None:
    def worst(name):
        return max(k[name]["rel_err"] for k in kc["pairs"])
    timed = "; ".join(
        f"{name} {k[name]['shape']} {k[name]['ms']:.3f} ms (plain "
        f"{k[name]['plain_ms']:.3f} ms)" for k in kc["pairs"]
        for name in ("unpack_dft", "dft_pack") if k[name]["ms"] is not None)
    print(f"  rank {r} service kernels at its own shapes ({MR_TAG}, one "
          f"rank at a time; CUDA events, mean of 10): {len(kc['pairs'])} "
          f"pairs, unpack_dft max rel err {worst('unpack_dft'):.1e}, "
          f"dft_pack {worst('dft_pack'):.1e}; {timed}; dft_matmul at "
          f"{len(kc['dft_matmul'])} line shapes, max rel err "
          f"{max(k['rel_err'] for k in kc['dft_matmul']):.1e}", flush=True)


def print_rank_kernels(r, kc) -> None:
    def t(k):
        return ("" if k["ms"] is None else
                f" {k['ms']:.3f} ms (plain {k['plain_ms']:.3f} ms)")
    print(f"  rank {r} kernels at its own shapes ({MR_TAG}, one rank at a "
          "time; CUDA events, mean of 10): " + "; ".join(
              f"{name} {k['shape']}{t(k)}, rel err {k['rel_err']:.1e}"
              for name, k in (("unpack_dft", kc["unpack_dft"]),
                              ("dft_pack", kc["dft_pack"]),
                              *(("dft_matmul", k)
                                for k in kc["dft_matmul"]))), flush=True)


def rho_agreement(torch, rho, ref) -> dict:
    """ρ against a reference ρ: largest difference and largest value."""
    return {"max_diff": float((rho - ref).abs().max()),
            "max_rho": float(ref.abs().max()), "shape": list(rho.shape),
            "finite": bool(torch.isfinite(rho).all())}


def multirank_rank(rank, job):
    """One rank of the multi-rank phase (a spawned process of
    ``repro_torch.sharding.procs.run_ranks``).  Sizes come in ``job``;
    the rank measures and compares, and returns what it found: the
    parent makes every check."""
    import numpy as np
    import torch

    from repro_torch.core import ProcGrid
    from repro_torch.core.plan import MoveStage
    from repro_torch.dft import PlaneWaveBasis, SCFConfig, run_scf
    from repro_torch.dft.hamiltonian import apply_hamiltonian_padded
    from repro_torch.kernels import sphere_pack
    from repro_torch.kernels.dft_matmul import dft_matmul
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    wrappers = (dft_matmul, sphere_pack.unpack_dft, sphere_pack.dft_pack)

    def zero():
        for fn in wrappers:
            fn.launches = 0

    def counts():
        return {fn.__name__: fn.launches for fn in wrappers}

    kpts = tuple(tuple(k) for k in job["kpts"])
    if job["kind"] == "pencil":
        from repro_torch.sharding.grids import choose_dft_grid
        grid = choose_dft_grid(nbands=job["nbands"], nk=len(kpts),
                               diameter=job["n"] // 2, device=dev)
        zero()
        stages = LineStages()
        with stages.record("pencil"):
            res = run_scf(SCFConfig(n=job["n"], nbands=job["nbands"],
                                    kpts=kpts, max_iter=50, backend="cuda"),
                          grid=grid)
        out = {"grid": grid.shape, "energy": res.energy,
               "converged": res.converged, "iterations": res.iterations,
               "stacked": res.stacked, "launches": counts()}
        zero()
        res = run_scf(SCFConfig(n=job["n"], nbands=job["nbands"], kpts=kpts,
                                max_iter=50, backend="cuda", jit_step=True),
                      grid=grid)
        out["fused"] = {"energy": res.energy, "converged": res.converged,
                        "iterations": res.iterations, "jitted": res.jitted,
                        "graphs": res.graphs.get("graphs"),
                        "host_syncs": res.graphs.get("host_syncs", []),
                        "launches": counts()}
        basis = PlaneWaveBasis(job["n"], kpts=kpts, nbands=job["nbands"],
                               grid=grid, backend="cuda")
        inv, _ = basis.stacked_hamiltonian_plans()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        c_pad = crandn(torch, gen, (len(kpts), job["nbands"],
                                    inv.npacked_max), dev)
        v = torch.rand(basis.field.local_shape, generator=gen, device=dev)
        out["kernels"] = rank_kernel_checks(
            torch, dev, basis, c_pad, v, stages.launched("pencil"), rank,
            grid.nprocs)
        return out

    data = np.load(job["inputs"])
    n, nb, nk = job["n"], job["nbands"], len(kpts)
    grid = ProcGrid.create(MR_GRID, MR_AXES, device=dev)
    basis = PlaneWaveBasis(n, diameter=job["d"], kpts=kpts, nbands=nb,
                           grid=grid, backend="cuda")
    coeffs = [torch.as_tensor(data[f"c{ik}"], device=dev)
              for ik in range(nk)]
    v = basis.field.scatter(torch.as_tensor(data["v"], device=dev))
    inv, _ = basis.stacked_hamiltonian_plans()
    c_pad = inv.stack(coeffs).reshape(nk, nb, inv.npacked_max)

    def happly():
        return apply_hamiltonian_padded(basis, c_pad, v)

    happly()                                 # plans, tables, first launch
    sync(torch, dev)
    zero()
    d0 = dict(sphere_pack.DISPATCHES)
    stages = LineStages()
    with stages.record("multirank"):
        hc = happly()
    sync(torch, dev)
    out = {"coordinate": grid.coordinate, "h_launches": counts(),
           "h_dispatches": {k: sphere_pack.DISPATCHES[k] - d0[k]
                            for k in d0},
           "h_ms": wall_ms(torch, happly, 3)}
    if rank == 0:
        ref = torch.as_tensor(data["hc"], device=dev)
        err = float((hc - ref).abs().max())
        pad = ~torch.as_tensor(data["valid"], device=dev)
        lanes = torch.view_as_real(hc[pad[:, None, :].expand_as(hc)])
        out["h_vs_one_rank"] = {
            "max_abs_err": err, "rel_err": err / float(ref.abs().max()),
            "padded_plus_zero": bool(((lanes == 0)
                                      & ~torch.signbit(lanes)).all()),
            "padded_lanes": int(pad.sum()) * nb}
        del ref, lanes
    # one all-to-all of the inverse transform, at its local shape
    rem = inv._fused_in_parts()["rem"]
    move = next(st for st in rem.stages if isinstance(st, MoveStage))
    x = torch.ones(rem.tin.local_shape, dtype=torch.complex64, device=dev)
    out["a2a_ms"] = wall_ms(torch, lambda: move.apply(x), 3)
    out["a2a_shape"] = list(x.shape)
    del hc, x
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    zero()
    stamps = []
    with stages.record("multirank"):
        res = run_scf(
            SCFConfig(n=n, diameter=job["d"], nbands=nb, kpts=kpts,
                      stack_k=True, backend="cuda", max_iter=job["iters"],
                      mix_warmup=job["iters"]),
            grid=grid, coeffs=coeffs,
            callback=lambda *a: stamps.append(time.perf_counter()))
    walls = [b - a for a, b in zip(stamps, stamps[1:])]
    out.update({
        "scf_launches": counts(), "energies": res.energies,
        "eigenvalues": res.eigenvalues, "grid_shape": res.grid_shape,
        "stacked": res.stacked,
        "first_s": res.iteration_records[0]["seconds"],
        "steady_s": sum(walls) / len(walls) if walls else None,
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                     if dev.type == "cuda" else None)})
    if rank == 0:
        ref = torch.as_tensor(data["rho"], device=dev)
        out["rho_vs_one_rank"] = rho_agreement(torch, res.rho, ref)
        del ref
    rho_eager = res.rho.cpu()
    del res
    # the fused step on the same grid, configuration and start, with
    # linear mixing as the one-rank fused run it is held against
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    zero()
    stamps = []
    res = run_scf(
        SCFConfig(n=n, diameter=job["d"], nbands=nb, kpts=kpts,
                  stack_k=True, backend="cuda", max_iter=job["iters"],
                  mix_warmup=job["iters"], mix_history=1, jit_step=True),
        grid=grid, coeffs=coeffs,
        callback=lambda *a: stamps.append(time.perf_counter()))
    walls = [b - a for a, b in zip(stamps, stamps[1:])]
    out["fused"] = {
        "launches": counts(), "energies": res.energies,
        "eigenvalues": res.eigenvalues, "jitted": res.jitted,
        "graphs": res.graphs.get("graphs"),
        "host_syncs": res.graphs.get("host_syncs", []),
        "replays": res.graphs.get("replays"),
        "capture_s": res.graphs.get("capture_seconds"),
        "first_s": res.iteration_records[0]["seconds"],
        "steady_s": sum(walls) / len(walls) if walls else None,
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                     if dev.type == "cuda" else None)}
    if rank == 0:
        ref = torch.as_tensor(data["rho_fused"], device=dev)
        out["fused"]["rho_vs_one_rank"] = rho_agreement(torch, res.rho, ref)
        out["fused"]["rho_vs_eager"] = rho_agreement(
            torch, res.rho, rho_eager.to(dev))
        del ref
    del res, rho_eager
    # every kernel of the path against its plain version at the rank's
    # shapes: kernel #1 at each line shape of its H apply and SCF
    out["kernels"] = rank_kernel_checks(
        torch, dev, basis, c_pad, v, stages.launched("multirank"), rank,
        grid.nprocs)
    return out


def sync_counts(names) -> dict:
    """The host syncs of one fused step by name, with their counts."""
    from collections import Counter
    return dict(Counter(names))


def check_multirank_fused(ranks, eager, one):
    """The parent's checks of the fused step on the 2×2 grid: against the
    same grid's eager run (``ranks[r]``'s eager record) and against one
    rank's fused run ``one``, to PERF.md §2's limits."""
    import numpy as np
    f0 = ranks[0]["fused"]
    for r, out in enumerate(ranks):
        f = out["fused"]
        print(f"  rank {r} {out['coordinate']}, fused step: {f['graphs']} "
              f"graphs and {len(f['host_syncs'])} host syncs per iteration,"
              f" first iteration (warm-up + capture) {f['first_s']:.3f} s, "
              f"steady {f['steady_s']:.3f} s/iteration, peak "
              f"{_gib(f['peak_gib'])} ({MR_TAG}); launches (the warm-up's "
              f"and the capture's; replays launch no wrapper) "
              f"{f['launches']}", flush=True)
        check(all(v > 0 for v in f["launches"].values()),
              f"rank {r}: kernels #1, #3, #4 launched in its fused step")
        check(f["energies"] == f0["energies"],
              f"rank {r}: the fused step's energies equal rank 0's")
        if f["graphs"] is not None:
            check(f["jitted"] and f["replays"] == len(f["energies"]) - 1,
                  f"rank {r}: the steady iterations replayed the graphs")
    print(f"  fused step host syncs per iteration, by name: "
          f"{sync_counts(f0['host_syncs'])}", flush=True)
    e = np.asarray(f0["energies"])
    out = {}
    for what, ref_e, ref_eig, rho in (
            ("2x2 eager run", ranks[0]["energies"], ranks[0]["eigenvalues"],
             f0["rho_vs_eager"]),
            ("one rank's fused step", one.energies, one.eigenvalues,
             f0["rho_vs_one_rank"])):
        er = np.asarray(ref_e)
        de = float(np.abs(e - er).max()) if len(e) == len(er) else np.inf
        deig = float(np.abs(f0["eigenvalues"] - ref_eig).max())
        check(bool(np.isfinite(e).all()) and de <= ENERGY_RTOL * max(
            1.0, float(np.abs(er).max())),
              f"fused step on {MR_GRID} vs the {what}: energies agree, max "
              f"|dE| {de:.3e}")
        check(deig <= EIG_ATOL * max(1.0, float(np.abs(ref_eig).max())),
              f"fused step on {MR_GRID} vs the {what}: eigenvalues agree, "
              f"max diff {deig:.3e}")
        check(rho["shape"] == [N, N, N] and rho["finite"]
              and rho["max_diff"] <= RHO_RTOL * rho["max_rho"],
              f"fused step on {MR_GRID} vs the {what}: rho agrees, max diff "
              f"{rho['max_diff']:.3e} <= {RHO_RTOL:g}·{rho['max_rho']:.3e}")
        out[what] = {"max_dE": de, "max_deig": deig,
                     "max_drho": rho["max_diff"]}
    steady = [o["fused"]["steady_s"] for o in ranks]
    print(f"  fused step: steady {max(steady):.3f} s/iteration (slowest "
          f"rank) against the eager run's "
          f"{max(o['steady_s'] for o in ranks):.3f} ({MR_TAG})", flush=True)
    return {"graphs": f0["graphs"], "host_syncs": sync_counts(
                f0["host_syncs"]),
            "steady_s_per_rank": steady,
            "first_s_per_rank": [o["fused"]["first_s"] for o in ranks],
            "capture_s_per_rank": [o["fused"]["capture_s"] for o in ranks],
            "peak_gib_per_rank": [o["fused"]["peak_gib"] for o in ranks],
            "launches_per_rank": [o["fused"]["launches"] for o in ranks],
            "agreement": out}

def run_multirank(torch, dev, ctx, gpu):
    """The multi-rank phase: the smoke SCF's stacked H apply and SCF on
    the 2×2 (batch × fft) grid over four processes, each held against the
    single-rank "cuda" run; then the (2, 2, 2) pencil grid over eight
    processes at n = 16.  Any rank's failure, or a run past
    ``MR_TIMEOUT``, fails the phase."""
    import numpy as np

    from repro_torch.dft import PlaneWaveBasis, SCFConfig, run_scf
    from repro_torch.dft.hamiltonian import apply_hamiltonian_padded
    from repro_torch.dft.potentials import gaussian_wells
    from repro_torch.sharding.procs import run_ranks
    print(f"multi-rank phase ({MR_TAG}; gloo carries each collective "
          "through host memory, so these times are per-rank costs of the "
          "local shard shapes, not a scaling measurement): grid "
          f"{MR_GRID} {MR_AXES}, n={N} d={DIAMETER} nbands={NBANDS} "
          f"kpts={KPTS} (B={len(KPTS) * NBANDS}), {MR_ITERS} SCF "
          f"iterations; card {gpu}", flush=True)
    os.makedirs(MR_DIR, exist_ok=True)
    path = os.path.join(MR_DIR, "inputs.npz")
    basis = PlaneWaveBasis(N, diameter=DIAMETER, kpts=KPTS, nbands=NBANDS,
                           device=dev, backend="cuda")
    inv, _ = basis.stacked_hamiltonian_plans()
    coeffs = ctx["coeffs"]
    v = gaussian_wells(N)
    c_pad = inv.stack(coeffs).reshape(len(KPTS), NBANDS, inv.npacked_max)
    hc = apply_hamiltonian_padded(basis, c_pad,
                                  torch.as_tensor(v, device=dev))
    ref = ctx["cuda"]
    if MR_ITERS != len(ref.energies):
        ref = run_scf(scf_config("cuda", max_iter=MR_ITERS,
                                 mix_warmup=MR_ITERS),
                      device=dev, coeffs=coeffs)
    fused = ctx["fused_linear"]
    if MR_ITERS != len(fused.energies):
        fused = run_scf(scf_config("cuda", max_iter=MR_ITERS,
                                   mix_warmup=MR_ITERS, mix_history=1,
                                   jit_step=True),
                        device=dev, coeffs=coeffs)
    np.savez(path, v=v, hc=hc.cpu().numpy(), rho=ref.rho.cpu().numpy(),
             rho_fused=fused.rho.cpu().numpy(), valid=inv.valid_lanes(),
             **{f"c{ik}": c.cpu().numpy() for ik, c in enumerate(coeffs)})
    del hc, c_pad
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    job = {"kind": "full", "device": str(dev), "inputs": path, "n": N,
           "d": DIAMETER, "nbands": NBANDS, "kpts": KPTS,
           "iters": MR_ITERS}
    t0 = time.perf_counter()
    ranks = run_ranks(multirank_rank, MR_PROCS, args=(job,),
                      rendezvous_dir=MR_DIR, timeout=MR_TIMEOUT,
                      threads=MR_THREADS)
    seconds = time.perf_counter() - t0
    os.remove(path)
    for r, out in enumerate(ranks):
        hl, sl = out["h_launches"], out["scf_launches"]
        print(f"  rank {r} {out['coordinate']}: H apply {out['h_ms']:.1f} "
              f"ms, one all-to-all of {out['a2a_shape']} "
              f"{out['a2a_ms']:.1f} ms, SCF first iteration "
              f"{out['first_s']:.3f} s, steady {out['steady_s']:.3f} "
              f"s/iteration, peak {_gib(out['peak_gib'])} ({MR_TAG}); "
              f"launches: H apply {hl}, SCF {sl}", flush=True)
        check(out["h_dispatches"] == {"unpack_dft": 1, "dft_pack": 1},
              f"rank {r}: the H apply took the fused route, x sharded")
        check(all(hl[k] > 0 for k in hl) and all(sl[k] > 0 for k in sl),
              f"rank {r}: kernels #1, #3, #4 launched in its H apply and "
              "its SCF")
        check(out["grid_shape"] == MR_GRID and out["stacked"],
              f"rank {r}: SCF on the {MR_GRID} grid, stacked route")
        print_rank_kernels(r, out["kernels"])
        check_rank_kernels(r, f"{MR_GRID}", out["kernels"])
    h = ranks[0]["h_vs_one_rank"]
    check(h["rel_err"] <= PAIR_RTOL,
          f"H apply on {MR_GRID} vs one rank: {h['max_abs_err']:.3e} "
          f"({h['rel_err']:.2e} of the largest value) <= {PAIR_RTOL:g}")
    check(h["padded_plus_zero"],
          f"H apply on {MR_GRID}: its {h['padded_lanes']} padded lanes are "
          "exactly +0.0 after the all-reduce")
    rho = ranks[0]["rho_vs_one_rank"]
    e, er = np.asarray(ranks[0]["energies"]), np.asarray(ref.energies)
    check(all(out["energies"] == ranks[0]["energies"] for out in ranks),
          "every rank reports the same energies")
    check(len(e) == len(er) == MR_ITERS and bool(np.isfinite(e).all()),
          f"{MR_ITERS} finite energies")
    de = float(np.abs(e - er).max())
    deig = float(np.abs(ranks[0]["eigenvalues"] - ref.eigenvalues).max())
    check(de <= ENERGY_RTOL * max(1.0, float(np.abs(er).max())),
          f"SCF on {MR_GRID} vs one rank: energies agree, max |dE| "
          f"{de:.3e}")
    check(deig <= EIG_ATOL * max(1.0, float(np.abs(ref.eigenvalues).max())),
          f"SCF on {MR_GRID} vs one rank: eigenvalues agree, max diff "
          f"{deig:.3e}")
    check(rho["shape"] == [N, N, N] and rho["finite"]
          and rho["max_diff"] <= RHO_RTOL * rho["max_rho"],
          f"SCF on {MR_GRID} vs one rank: rho agrees, max diff "
          f"{rho['max_diff']:.3e} <= {RHO_RTOL:g}·{rho['max_rho']:.3e}")
    steady = [out["steady_s"] for out in ranks]
    print(f"  {MR_PROCS} ranks: steady {max(steady):.3f} s/iteration "
          f"(slowest rank), {seconds:.1f} s for the whole run ({MR_TAG})",
          flush=True)
    mr_fused = check_multirank_fused(ranks, ref, fused)

    # the pencil grid of the reference's case, against one rank
    pcfg = SCFConfig(n=PENCIL_N, nbands=PENCIL_NBANDS, kpts=KPTS,
                     max_iter=50, backend="cuda", stack_k=True)
    one = run_scf(pcfg, device=dev)
    job = {"kind": "pencil", "device": str(dev), "n": PENCIL_N,
           "nbands": PENCIL_NBANDS, "kpts": KPTS}
    t0 = time.perf_counter()
    pencil = run_ranks(multirank_rank, PENCIL_PROCS, args=(job,),
                       rendezvous_dir=MR_DIR, timeout=MR_TIMEOUT / 2,
                       threads=1)
    pseconds = time.perf_counter() - t0
    for r, out in enumerate(pencil):
        check(out["grid"] == (2, 2, 2) and out["converged"]
              and out["stacked"]
              and all(c > 0 for c in out["launches"].values()),
              f"pencil rank {r}: grid {out['grid']} from choose_dft_grid, "
              f"converged in {out['iterations']}, launches "
              f"{out['launches']}")
        print_rank_kernels(r, out["kernels"])
        check_rank_kernels(r, "pencil", out["kernels"])
    dp = abs(pencil[0]["energy"] - one.energy)
    check(len({out["energy"] for out in pencil}) == 1
          and dp <= ENERGY_RTOL * abs(one.energy),
          f"pencil SCF (n={PENCIL_N}, 8 processes): E "
          f"{pencil[0]['energy']:.6f} vs one rank {one.energy:.6f}, "
          f"|dE| {dp:.2e}")
    pf = pencil[0]["fused"]
    dpf = abs(pf["energy"] - pencil[0]["energy"])
    print(f"  pencil fused step: {pf['graphs']} graphs and "
          f"{len(pf['host_syncs'])} host syncs per iteration "
          f"({sync_counts(pf['host_syncs'])}), {pf['iterations']} "
          f"iterations; launches per rank "
          f"{[out['fused']['launches'] for out in pencil]}", flush=True)
    check(all(out["fused"]["converged"] and out["fused"]["energy"]
              == pf["energy"] for out in pencil)
          and dpf <= ENERGY_RTOL * abs(pencil[0]["energy"]),
          f"pencil fused step (jit_step=True, 8 processes): converged, E "
          f"{pf['energy']:.6f} vs its eager run, |dE| {dpf:.2e}")
    check(all(out["fused"]["jitted"] for out in pencil)
          or dev.type != "cuda",
          "pencil fused step replayed CUDA graphs on every rank")
    print(f"  pencil run: {pseconds:.1f} s (8 processes on one card, "
          "gloo)", flush=True)
    return {"tag": MR_TAG, "grid": list(MR_GRID), "iterations": MR_ITERS,
            "seconds": seconds, "steady_s_per_rank": steady,
            "h_ms_per_rank": [out["h_ms"] for out in ranks],
            "a2a_ms_per_rank": [out["a2a_ms"] for out in ranks],
            "a2a_shape": ranks[0]["a2a_shape"],
            "first_s_per_rank": [out["first_s"] for out in ranks],
            "peak_gib_per_rank": [out["peak_gib"] for out in ranks],
            "h_apply_vs_one_rank": h, "max_dE": de, "max_deig": deig,
            "max_drho": rho["max_diff"],
            "launches_per_rank": [out["scf_launches"] for out in ranks],
            "h_launches_per_rank": [out["h_launches"] for out in ranks],
            "kernels_per_rank": [out["kernels"] for out in ranks],
            "fused": mr_fused,
            "pencil": {"energy": pencil[0]["energy"],
                       "one_rank_energy": one.energy, "dE": dp,
                       "iterations": pencil[0]["iterations"],
                       "seconds": pseconds,
                       "launches_per_rank": [out["launches"]
                                             for out in pencil],
                       "fused": {"energy": pf["energy"], "dE": dpf,
                                 "iterations": pf["iterations"],
                                 "graphs": pf["graphs"],
                                 "host_syncs": len(pf["host_syncs"]),
                                 "launches_per_rank": [
                                     out["fused"]["launches"]
                                     for out in pencil]},
                       "kernels_per_rank": [out["kernels"]
                                            for out in pencil]}}



def multirank_service_rank(rank, job):
    """One rank of the multi-rank service phase (a spawned process of
    ``run_ranks``): rank 0 is the service's front end and sends the trace
    three times (:func:`serve_trace`), holding every result against the
    one-rank service's; the other ranks follow it (``start``, then
    ``stop``, which returns on the front end's stop).  Each rank counts
    its kernel launches from 0 over the run."""
    import numpy as np
    import torch

    from repro_torch.core import ProcGrid
    from repro_torch.kernels import sphere_pack
    from repro_torch.kernels.dft_matmul import dft_matmul
    from repro_torch.serve import DeadlineExceeded
    # the service's sizes as the parent has them (a spawned process
    # imports this module afresh)
    globals().update(job["sizes"])
    stages = LineStages()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    grid = ProcGrid.create(MR_GRID, MR_AXES, device=dev)
    wrappers = (dft_matmul, sphere_pack.unpack_dft, sphere_pack.dft_pack)
    for fn in wrappers:
        fn.launches = 0
    out = {"coordinate": grid.coordinate}
    t0 = time.perf_counter()
    if rank == grid.ranks[0]:
        reqs = service_requests(np.random.default_rng(SEED + 2))
        with stages.record("service"):
            svc, passes = serve_trace(dev, "cuda", reqs, grid=grid)
        one = np.load(job["one_rank"])
        ok = [i for i, r in enumerate(reqs) if r["deadline"] is None]
        late = [i for i, r in enumerate(reqs) if r["deadline"] is not None]
        rel, bitwise, resolved = 0.0, True, True
        for p in passes:
            for i in ok:
                got, want = p["results"][i], one[f"r{i}"]
                if not isinstance(got, np.ndarray):
                    resolved = False
                    continue
                rel = max(rel, float(np.abs(got - want).max()
                                     / np.abs(want).max()))
                bitwise &= bool(np.array_equal(got, want))
        out.update({
            "passes": [{"name": p["name"], "summary": p["summary"],
                        "batches": p["batches"],
                        "dispatch_ms": p["dispatch_ms"],
                        "pieces": p["pieces"]} for p in passes],
            "resolved": resolved, "rel_err": rel, "bitwise": bitwise,
            "late_failed": all(isinstance(p["results"][i],
                                          DeadlineExceeded)
                               for p in passes for i in late),
            "padding": svc.padding})
    else:
        svc = make_service(dev, "cuda", grid)
        with stages.record("service"):
            svc.start()
            svc.stop(timeout=job["timeout"])
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {fn.__name__: fn.launches for fn in wrappers}
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                       if dev.type == "cuda" else None)
    # every kernel of the path against its plain version at the rank's
    # shapes, after the count: #3 and #4 on every pair the rank ran, #1
    # at each line shape of its dispatches and warm-ups
    out["kernels"] = service_kernel_checks(
        torch, dev, svc.pairs, stages.launched("service"), rank, grid.nprocs)
    return out


def service_kernel_checks(torch, dev, pairs, lines, rank, world):
    """Kernels #3 and #4 of every plan pair a service rank ran
    (:func:`watch_pairs`; the same pairs in the same order on every rank)
    against their plain versions, on random rows and a random potential
    of the rank's shapes, the first pair of each (sphere extents, bucket)
    timed; kernel #1 at each line shape in ``lines``."""
    gen = torch.Generator(device=dev).manual_seed(SEED + rank)
    out = {"pairs": []}
    timed = set()
    for (_, bucket), (extents, inv, fwd) in pairs.items():
        rows = inv.local_rows(crandn(torch, gen, (bucket, inv.npacked_max),
                                     dev)).contiguous()
        v = torch.rand(inv.tout.local_shape[1:], generator=gen, device=dev)
        k = pair_kernel_checks(torch, dev, inv, fwd, rows, v, rank, world,
                               timed=(extents, bucket) not in timed)
        timed.add((extents, bucket))
        out["pairs"].append({"extents": list(extents), "bucket": bucket,
                             **k})
        del rows, v
    out["dft_matmul"] = line_kernel_checks(torch, dev, lines, rank, world)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run_multirank_service(torch, dev, gpu, served):
    """The service phase's trace on the 2×2 (batch × fft) grid of four
    processes over gloo, front end rank 0: every result held against the
    one-rank service's (``served``, its warm pass), padded lanes +0.0,
    the deadline=0.0 request failed, kernels #1, #3, #4 launched on every
    rank.  Any rank's failure, or a run past ``MR_TIMEOUT``, fails it."""
    import numpy as np

    from repro_torch.sharding.procs import run_ranks
    print(f"multi-rank service ({MR_TAG}): grid {MR_GRID} {MR_AXES} "
          f"(batch x fft), n={SERVICE_N}, max_rows={SERVICE_MAX_ROWS}, "
          f"backend cuda, front end rank 0, start() + async warming; card "
          f"{gpu}", flush=True)
    os.makedirs(MR_DIR, exist_ok=True)
    path = os.path.join(MR_DIR, "service.npz")
    np.savez(path, **{f"r{i}": r for i, r in enumerate(served)
                      if isinstance(r, np.ndarray)})
    job = {"device": str(dev), "one_rank": path, "timeout": MR_TIMEOUT,
           "sizes": {k: globals()[k] for k in (
               "SERVICE_N", "SERVICE_D", "SERVICE_D_SMALL",
               "SERVICE_MAX_ROWS")}}
    t0 = time.perf_counter()
    ranks = run_ranks(multirank_service_rank, MR_PROCS, args=(job,),
                      rendezvous_dir=MR_DIR, timeout=MR_TIMEOUT,
                      threads=MR_THREADS)
    seconds = time.perf_counter() - t0
    os.remove(path)
    front = ranks[0]
    for p in front["passes"]:
        s = p["summary"]
        print(f"  {p['name']} pass ({MR_TAG}, {gpu}): latency p50 "
              f"{s['latency_p50_ms']} ms, p99 {s['latency_p99_ms']} ms, "
              f"{s['requests_per_s']} requests/s, {s['dispatches']} "
              f"dispatches ({s['coalesced_dispatches']} coalesced); "
              f"batches {p['batches']}", flush=True)
    warm = front["passes"][1]
    print(f"  warm pass: serve.dispatch spans {warm['dispatch_ms']} ms",
          flush=True)
    print_pieces(f"synced pass ({MR_TAG})", front["passes"][2]["pieces"])
    for r, out in enumerate(ranks):
        print(f"  rank {r} {out['coordinate']}: launches {out['launches']},"
              f" {out['seconds']:.1f} s, peak {_gib(out['peak_gib'])} "
              f"({MR_TAG})", flush=True)
        check(all(v > 0 for v in out["launches"].values()),
              f"rank {r}: kernels #1, #3, #4 launched in its dispatches")
        kc = out["kernels"]
        check(len(kc["pairs"]) > 0, f"service rank {r}: pairs recorded")
        for i, k in enumerate(kc["pairs"]):
            check_pair_kernels(f"service rank {r} pair {i} (sphere extents "
                               f"{tuple(k['extents'])}, bucket "
                               f"{k['bucket']})", k)
        check_line_kernels(f"service rank {r}", kc["dft_matmul"])
        print_service_kernels(r, kc)
    check(front["resolved"] and front["late_failed"],
          "every request resolved on the front end, the deadline=0.0 one "
          "with DeadlineExceeded")
    check(front["passes"][0]["summary"]["coalesced_dispatches"] >= 1,
          "requests coalesced on the grid")
    check(front["rel_err"] <= KERNEL_RTOL,
          f"every result vs the one-rank service: max rel err "
          f"{front['rel_err']:.3e} <= {KERNEL_RTOL:g}; bitwise "
          f"{front['bitwise']}")
    pad = front["padding"]
    check(pad["plus_zero"] and pad["padded_lanes"] > 0,
          f"the {pad['padded_lanes']} padded lanes of {pad['blocks']} "
          "packed blocks are exactly +0.0")
    print(f"  {MR_PROCS} ranks: {seconds:.1f} s for the whole run "
          f"({MR_TAG})", flush=True)
    return {"tag": MR_TAG, "grid": list(MR_GRID), "seconds": seconds,
            "passes": [{k: p[k] for k in ("name", "summary",
                                           "dispatch_ms", "pieces")}
                       for p in front["passes"]],
            "rel_err": front["rel_err"], "bitwise": front["bitwise"],
            "padding": pad,
            "launches_per_rank": [out["launches"] for out in ranks],
            "kernels_per_rank": [out["kernels"] for out in ranks],
            "seconds_per_rank": [out["seconds"] for out in ranks],
            "peak_gib_per_rank": [out["peak_gib"] for out in ranks]}

def breakdown(torch, dev):
    """Host-clock time of each piece of one SCF iteration, per route.

    One iteration is 2 Hartree solves (v_eff and the energy), 2·inner_steps
    stacked H applies, inner_steps band-update linalg steps (descent
    direction + Rayleigh-Ritz), one density build and one mixing step;
    the model sums those against the measured iteration.
    """
    import numpy as np

    from repro_torch.dft import (HartreeSolver, PlaneWaveBasis,
                                 apply_hamiltonian_padded,
                                 density_from_orbitals)
    from repro_torch.dft.hamiltonian import (_descent_direction_stacked,
                                             _rayleigh_ritz_stacked)
    from repro_torch.dft.scf import AndersonMixer, SCFConfig

    steps = SCFConfig().inner_steps

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    v = torch.randn((N, N, N), generator=gen, device=dev)
    rho = torch.rand((N, N, N), generator=gen, device=dev)
    out = {}
    for backend in ("cuda", "matmul"):
        b = PlaneWaveBasis(N, diameter=DIAMETER, kpts=KPTS, nbands=NBANDS,
                           backend=backend, device=dev)
        inv, _ = b.stacked_hamiltonian_plans()
        c = crandn(torch, gen, (b.nk, NBANDS, b.npacked_max), dev)
        tab = b.stacked_band_tables()
        blocks = inv.split(c.reshape(-1, b.npacked_max))
        hart = HartreeSolver(b)
        occ = np.ones((b.nk, NBANDS))
        mixer = AndersonMixer(history=5, warmup=MAX_ITER)
        t = {"hartree_ms": wall_ms(torch, lambda: hart(rho)),
             "h_apply_ms": wall_ms(
                 torch,
                 lambda: apply_hamiltonian_padded(b, c, v, tab.kinetic)),
             "linalg_step_ms": wall_ms(
                 torch, lambda: _rayleigh_ritz_stacked(
                     c, _descent_direction_stacked(c, c, tab.precond), c,
                     c)),
             "density_ms": wall_ms(
                 torch,
                 lambda: density_from_orbitals(b, blocks, occ)),
             "mix_ms": wall_ms(torch, lambda: mixer.mix(rho, rho))}
        t["model_iteration_ms"] = (2 * t["hartree_ms"]
                                   + 2 * steps * t["h_apply_ms"]
                                   + steps * t["linalg_step_ms"]
                                   + t["density_ms"] + t["mix_ms"])
        out[backend] = t
        print(f"  {backend:6s}: " + ", ".join(
            f"{k} {val:.1f}" for k, val in t.items()), flush=True)
        del c, blocks
    return out


def compare_kernel1(torch, dev, other: str, pairs: int = 10) -> list:
    """Kernel #1 of this tree against kernel #1 built from the sources of
    another checkout ``other`` (a ``git archive`` of an earlier commit),
    in ``pairs`` pairs per line shape of ``CALL_C_MS``, alternating which
    side runs first; each side's time is the mean of launches enough for
    ~5 ms.  Prints and returns each shape's medians and their ratio."""
    import ctypes
    import statistics

    from repro_torch.core.local_fft import dft_matrix_device
    from repro_torch.kernels import build
    from repro_torch.kernels.ops import dft_operand_device
    src = os.path.join(other, "src/repro_torch/kernels/csrc/dft_matmul.cu")
    so = os.path.join(HERE, "build", "compare", "dft_matmul_other.so")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, src],
                   check=True, capture_output=True, timeout=600)
    libs = {"other": ctypes.CDLL(so), "this": build.library("dft_matmul")}
    p, i = ctypes.c_void_p, ctypes.c_int
    libs["other"].dft_matmul_launch.argtypes = [p, p, p, ctypes.c_longlong,
                                                i, i, i, p]
    libs["other"].dft_matmul_launch.restype = i
    stream = torch.cuda.current_stream(dev).cuda_stream
    print(f"kernel #1, this tree against {other} ({gpu_line()}; {pairs} "
          "alternating pairs per shape, medians):", flush=True)
    rows = []
    for (M, K, Nn, inverse) in CALL_C_MS:
        x = crandn(torch, torch.Generator(device=dev).manual_seed(SEED),
                   (M, K), dev)
        _, _, w = dft_matrix_device(Nn, K, inverse, dev)
        ws = dft_operand_device(Nn, K, inverse, w.device)
        y = torch.empty((M, Nn), dtype=torch.complex64, device=dev)

        def launch(lib):
            build.check(lib.dft_matmul_launch(
                x.data_ptr(), ws.data_ptr(), y.data_ptr(), M, Nn, K, 1,
                stream), "dft_matmul")
        reps = max(5, int(5.0 / time_ms(torch, lambda: launch(libs["this"]),
                                        reps=3)))
        times = {"this": [], "other": []}
        for k in range(pairs):
            for side in (("other", "this") if k % 2 == 0 else
                         ("this", "other")):
                times[side].append(time_ms(
                    torch, lambda side=side: launch(libs[side]), reps=reps,
                    warmup=1))
        med = {k: statistics.median(v) for k, v in times.items()}
        wins = sum(a < b for a, b in zip(times["this"], times["other"]))
        rows.append({"lines": M, "n_in": K, "n_out": Nn, "inverse": inverse,
                     "this_ms": med["this"], "other_ms": med["other"],
                     "ratio": med["this"] / med["other"], "wins": wins})
        print(f"  {M}x{K}->{Nn}{' inv' if inverse else ''}: this "
              f"{med['this']:.3f} ms, other {med['other']:.3f} ms, ratio "
              f"{med['this'] / med['other']:.3f}, this faster in {wins} of "
              f"{pairs} pairs", flush=True)
        del x, y
    return rows


# ------------------------------------------------------- the paper workload
def stage_walk(stages, shape, last, held, *, model="cuda"):
    """Peak live bytes of the eager executor over ``stages`` (complex64).

    ``shape`` is the input's logical shape, ``last`` the logical axis that
    is innermost in memory, ``held`` the bytes that stay allocated
    throughout (the caller's tensors, this input among them).  A stage on
    axis a writes its output with a innermost; on the "cuda" backend its
    input is first copied into lines (``movedim`` + ``reshape``) unless a
    is already innermost.  On the "matmul" backend a stage may hold up to
    its input again (the real and imaginary operands) and three times
    its output (the f32 products and planes, then the complex result).
    Returns ``(peak, output shape, output's innermost axis)``; a
    distributed move on one process is the identity and costs nothing.
    """
    from repro_torch.core.plan import FFTStage
    peak, prev = held, 0
    shape = list(shape)
    for st in stages:
        if not isinstance(st, FFTStage):
            continue
        in_b = 8 * math.prod(shape)
        shape[st.index] = st.n_out
        out_b = 8 * math.prod(shape)
        if model == "cuda":
            extra = (in_b if st.index != last else 0) + out_b
        else:
            extra = in_b + 3 * out_b
        peak = max(peak, held + prev + extra)
        prev, last = out_b, st.index
    return peak, tuple(shape), last


def pair_peak_bytes(inv, fwd, chk_inv, chk_fwd, nb, bands, npk, n,
                    d) -> int:
    """The paper phase's peak device bytes at a band batch of ``nb``, from
    the plans' stage shapes: the packed coefficients of all ``bands``
    bands stay on the card; the fused inverse (kernel #3 writes the (nb, d, d, n) slab,
    which the caller holds while the other stages run), the fused forward
    from the cube it made (the cube held; kernel #4 writes the packed
    result), and the "matmul" route's check ``chk_*`` (PAPER_CHECK_BANDS
    bands a call) while the cube and the round trip are held."""
    coeffs = 8 * bands * npk
    slab = 8 * nb * d * d * n
    inv_peak, cube_shape, last = stage_walk(
        inv.plan.stages[1:], (nb, d, d, n), 3, coeffs + slab)
    cube = 8 * math.prod(cube_shape)
    fwd_peak, slab_shape, _ = stage_walk(
        fwd.plan.stages[:-1], cube_shape, last, coeffs + cube)
    fwd_peak = max(fwd_peak, coeffs + cube + 8 * math.prod(slab_shape)
                   + 8 * nb * npk)
    held = coeffs + cube + 8 * nb * npk
    c = PAPER_CHECK_BANDS
    unpacked = 8 * c * d ** 3
    chk_inv_peak, _, _ = stage_walk(chk_inv.plan.stages, (c, d, d, d), 3,
                                    held + unpacked, model="matmul")
    chk_fwd_peak, _, _ = stage_walk(chk_fwd.plan.stages, (c, n, n, n), last,
                                    held, model="matmul")
    return max(inv_peak, fwd_peak, chk_inv_peak, chk_fwd_peak + 8 * c * npk)


def pair_bound(nb, lanes, n, d) -> dict:
    """The least time of one inverse (or forward) of the pair for ``nb``
    bands: the fused z stage's MACs over this run's ``lanes`` packed lanes
    (each feeds n outputs), then the two dense stages over d→n lines
    (B·d·n and B·n² lines); 8 FLOP per complex MAC.  Bytes: the packed
    coefficients read once, the n³ cube written once."""
    macs = n * lanes + nb * d * n * d * n + nb * n * n * d * n
    return bound_ms(8.0 * (lanes + nb * n ** 3), 8.0 * macs)


def run_paper(torch, dev, gen, gpu):
    """The paper's own workload at full width: the configuration of
    ``repro_torch.configs.fftb_paper`` (n = 256, d = 128, 256 bands), its
    grid from ``choose_dft_grid``, audited by ``preflight_basis``, then the
    fused plane-wave pair of ``make_planewave_pair`` on "cuda" over every
    band, in batches of the largest of ``PAPER_BATCHES`` that the memory
    estimate fits; then the full-cube baseline of the paper's Fig. 9."""
    from repro_torch.check import preflight_basis
    from repro_torch.check.preflight import _basis_plan_bytes
    from repro_torch.configs.fftb_paper import CONFIG as cfg
    from repro_torch.core import SphereDomain, make_planewave_pair
    from repro_torch.core.planewave import kpoint_sphere
    from repro_torch.kernels import sphere_pack
    from repro_torch.kernels.dft_matmul import dft_matmul
    from repro_torch.sharding import DFT_AXES_1D, choose_dft_grid
    n, d = cfg.n, cfg.diameter
    print(f"paper workload ({cfg.name}): n={n} d={d} nb={cfg.nb} "
          f"({gpu})", flush=True)
    grid = choose_dft_grid(nbands=cfg.nb, diameter=d, device=dev)
    check(grid.shape == (1,) and grid.axes == DFT_AXES_1D
          and grid.device == dev,
          f"choose_dft_grid: {grid.shape} {grid.axes} on {grid.device}")
    diags = preflight_basis(n, diameter=d, nbands=cfg.nb, grid=grid,
                            backend="cuda", deep=True)
    check(diags == [], f"preflight_basis(deep, backend='cuda') is clean "
          f"({[dg.code for dg in diags]})")
    plan_bytes = _basis_plan_bytes([kpoint_sphere(d)], ((0,),), cfg.nb, n,
                                   d)
    print(f"  preflight: plan-cache working set {plan_bytes} bytes "
          "(_basis_plan_bytes)", flush=True)
    sph = SphereDomain.from_diameter(d)
    npk = sph.npacked
    chk_inv, chk_fwd = make_planewave_pair(grid, n, sph, PAPER_CHECK_BANDS,
                                           backend="matmul")
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    base = torch.cuda.memory_allocated(dev)
    limit = PAPER_MEM_SHARE * free
    est = {}
    nb = pair = None
    for cand in PAPER_BATCHES:
        p = make_planewave_pair(grid, n, sph, cand, backend="cuda")
        est[cand] = pair_peak_bytes(*p, chk_inv, chk_fwd, cand, cfg.nb,
                                    npk, n, d)
        if nb is None and est[cand] <= limit:
            nb, pair = cand, p
    print("  memory estimate before any launch: " + ", ".join(
        f"nb={k} {v / 2**30:.2f} GiB" for k, v in est.items())
        + f"; free {free / 2**30:.2f} of {total / 2**30:.2f} GiB, limit "
        f"{PAPER_MEM_SHARE:g} x free = {limit / 2**30:.2f} GiB", flush=True)
    check(nb is not None, f"a band batch of {PAPER_BATCHES} fits")
    inv, fwd = pair
    batches = cfg.nb // nb
    reduced = ({} if nb == cfg.nb else
               {"band_batch": f"{cfg.nb} -> {nb} bands per call "
                f"({batches} calls each way; the estimate at {cfg.nb} is "
                f"{est[cfg.nb] / 2**30:.2f} GiB)"})
    print(f"  band batch nb={nb}, {batches} batch(es); reduced: "
          + json.dumps(reduced), flush=True)

    coeffs = crandn(torch, gen, (cfg.nb, npk), dev)
    torch.cuda.reset_peak_memory_stats(dev)
    wrappers = (dft_matmul, sphere_pack.unpack_dft, sphere_pack.dft_pack)
    counts = {}
    errs = {"cube": [0.0, 0.0], "forward": [0.0, 0.0], "round_trip": 0.0}
    cmax = float(coeffs.abs().max())
    for b in range(batches):
        packed = coeffs[b * nb:(b + 1) * nb]
        for fn in wrappers:
            fn.launches = 0
        cube = inv.unpack_transform(packed)
        sync(torch, dev)
        if b == 0:
            counts["inverse"] = {fn.__name__: fn.launches for fn in wrappers}
            for fn in wrappers:
                fn.launches = 0
        back = fwd.transform_pack(cube)
        sync(torch, dev)
        if b == 0:
            counts["forward"] = {fn.__name__: fn.launches for fn in wrappers}
        check(tuple(cube.shape) == (nb, n, n, n) and bool(
            torch.isfinite(torch.view_as_real(back)).all()),
            f"batch {b}: cube {tuple(cube.shape)}, finite round trip")
        errs["round_trip"] = max(errs["round_trip"],
                                 float((back - packed).abs().max()))
        for j in range(0, nb, PAPER_CHECK_BANDS):
            sl = slice(j, j + PAPER_CHECK_BANDS)
            ref = chk_inv.unpack_transform(packed[sl])
            e = errs["cube"]
            e[0] = max(e[0], float((cube[sl] - ref).abs().max()))
            e[1] = max(e[1], float(ref.abs().max()))
            del ref
            ref = chk_fwd.transform_pack(cube[sl])
            e = errs["forward"]
            e[0] = max(e[0], float((back[sl] - ref).abs().max()))
            e[1] = max(e[1], float(ref.abs().max()))
            del ref
        del cube, back
    rel = {"cube": errs["cube"][0] / errs["cube"][1],
           "forward": errs["forward"][0] / errs["forward"][1],
           "round_trip": errs["round_trip"] / cmax}
    print(f"  launches per call: inverse {counts['inverse']}, forward "
          f"{counts['forward']}", flush=True)
    check(counts["inverse"] == {"dft_matmul": 2, "unpack_dft": 1,
                                "dft_pack": 0},
          "inverse: unpack_dft once, then dft_matmul per remaining stage")
    check(counts["forward"] == {"dft_matmul": 2, "unpack_dft": 0,
                                "dft_pack": 1},
          "forward: dft_matmul per stage, then dft_pack once")
    for name, r in rel.items():
        check(r <= PAIR_RTOL, f"{name}: "
              + ("cuda vs matmul route" if name != "round_trip" else
                 "fwd(inv(c)) vs c")
              + f", rel err {r:.3e} of the largest value <= {PAIR_RTOL:g}")

    # times: the last batch's coefficients, CUDA events
    packed = coeffs[(batches - 1) * nb:]
    cube = inv.unpack_transform(packed)
    fwd_ms = time_ms(torch, lambda: fwd.transform_pack(cube), reps=5)

    def all_forward():             # each batch's forward, from one cube
        for _ in range(batches):
            fwd.transform_pack(cube)
    all_fwd_ms = time_ms(torch, all_forward, reps=1, warmup=0)
    del cube
    inv_ms = time_ms(torch, lambda: inv.unpack_transform(packed), reps=5)

    def all_inverse():
        for b in range(batches):
            inv.unpack_transform(coeffs[b * nb:(b + 1) * nb])
    all_inv_ms = time_ms(torch, all_inverse, reps=1, warmup=0)
    peak = torch.cuda.max_memory_allocated(dev)
    lanes = nb * npk
    bnd = pair_bound(nb, lanes, n, d)
    bnd_all = pair_bound(cfg.nb, cfg.nb * npk, n, d)
    print(f"  inverse {inv_ms:.3f} ms, forward {fwd_ms:.3f} ms per call of "
          f"{nb} bands (mean of 5); all {cfg.nb} bands: inverse "
          f"{all_inv_ms:.3f} ms, forward {all_fwd_ms:.3f} ms; per call "
          f"{bound_text(bnd)}; all bands bound {bnd_all['bound_ms']:.3f} ms"
          f" ({gpu})", flush=True)
    print(f"  peak memory: estimated {(base + est[nb]) / 2**30:.2f} GiB "
          f"({est[nb] / 2**30:.2f} above the {base / 2**30:.2f} GiB "
          f"allocated before), measured {peak / 2**30:.2f} GiB "
          "(max_memory_allocated)", flush=True)
    del coeffs, packed
    torch.cuda.empty_cache()
    out = {"grid": list(grid.shape), "plan_cache_bytes": plan_bytes,
           "band_batch": nb, "batches": batches, "reduced": reduced,
           "estimate_gib": {k: v / 2**30 for k, v in est.items()},
           "free_gib": free / 2**30, "limit_gib": limit / 2**30,
           "peak_gib": peak / 2**30, "allocated_before_gib": base / 2**30,
           "launches_per_call": counts, "rel_err": rel,
           "inverse_ms": inv_ms, "forward_ms": fwd_ms,
           "all_bands_inverse_ms": all_inv_ms,
           "all_bands_forward_ms": all_fwd_ms, "bound": bnd,
           "all_bands_bound_ms": bnd_all["bound_ms"]}
    out["full_cube"] = full_cube_baseline(torch, dev, gen, grid, n, cfg.nb)
    return out


def full_cube_baseline(torch, dev, gen, grid, n, bands):
    """The paper's Fig. 9 baseline: an inverse FftPlan over the whole
    (nb, n³) cube (no sphere: each stage a dense n→n line DFT, kernel #1
    only), built as the reference's dry run builds it, at the largest of
    ``PAPER_BATCHES`` whose estimate fits; held to ``torch.fft.ifftn`` on
    two bands."""
    from repro_torch.core import DistTensor, Domain, FftPlan
    from repro_torch.kernels.dft_matmul import dft_matmul
    free, _ = torch.cuda.mem_get_info(dev)
    limit = PAPER_MEM_SHARE * free
    cube = Domain((0, 0, 0), (n - 1,) * 3)
    est, nb, plan = {}, None, None
    for cand in PAPER_BATCHES:
        bdom = Domain((0,), (cand - 1,))
        p = FftPlan(DistTensor.create((bdom, cube), "b x{0} y z", grid),
                    DistTensor.create((bdom, cube), "B X Y Z{0}", grid),
                    [("x", "X"), ("y", "Y"), ("z", "Z")], inverse=True,
                    backend="cuda")
        in_b = 8 * cand * n ** 3
        est[cand] = stage_walk(p.stages, (cand, n, n, n), 3, in_b)[0]
        if nb is None and est[cand] <= limit:
            nb, plan = cand, p
    print("  full-cube baseline: estimate " + ", ".join(
        f"nb={k} {v / 2**30:.2f} GiB" for k, v in est.items())
        + f"; limit {limit / 2**30:.2f} GiB", flush=True)
    check(nb is not None, "a full-cube batch fits")
    x = crandn(torch, gen, (nb, n, n, n), dev)
    dft_matmul.launches = 0
    y = plan(x)
    sync(torch, dev)
    launches = dft_matmul.launches
    e, r = rel_err(torch, y[:2], torch.fft.ifftn(x[:2], dim=(1, 2, 3)))
    del y
    check(launches == 3 and r <= PAIR_RTOL,
          f"full cube ({nb}, {n}^3): dft_matmul x{launches}, vs "
          f"torch.fft.ifftn rel err {r:.3e} <= {PAIR_RTOL:g}")
    ms = time_ms(torch, lambda: plan(x), reps=3, warmup=1)
    b = bound_ms(8.0 * 2 * nb * n ** 3, 8.0 * 3 * nb * n ** 4)
    scale = bands / nb
    print(f"  full-cube baseline: {ms:.3f} ms per call of {nb} bands "
          f"(mean of 3), {ms * scale:.3f} ms for {bands} bands at "
          f"that rate; {bound_text(b)} per call", flush=True)
    del x
    torch.cuda.empty_cache()
    return {"band_batch": nb, "estimate_gib": {
        k: v / 2**30 for k, v in est.items()}, "ms": ms,
        "all_bands_ms_at_rate": ms * scale, "launches_per_call": launches,
        "rel_err": r, "bound": b}


# ------------------------------------------------------ the spectral layers
def check_spectral(torch, dev, gen, stages):
    """``fourier_mixer`` and ``fft_conv`` on the "cuda" backend (every
    line DFT one launch of kernel #1), held to the "matmul" route and to
    torch.fft (the "fft" backend) on the same inputs."""
    from repro_torch.core import fft_conv, fourier_mixer
    from repro_torch.kernels.dft_matmul import dft_matmul
    x = torch.randn(MIXER_SHAPE, generator=gen, device=dev)
    xc = torch.randn(CONV_SHAPE, generator=gen, device=dev)
    k = torch.randn((CONV_K, CONV_SHAPE[-1]), generator=gen, device=dev)
    out = {}
    for name, fn, want_launches in (
            ("fourier_mixer", lambda be: fourier_mixer(x, backend=be), 2),
            ("fft_conv", lambda be: fft_conv(xc, k, backend=be), 3)):
        dft_matmul.launches = 0
        with stages.record(f"spectral:{name}") as shapes:
            y = fn("cuda")
        sync(torch, dev)
        launches = dft_matmul.launches
        lines = sorted(f"{m}x{a}->{b}{' inv' if i else ''}"
                       for m, a, b, i in shapes)
        check(launches == want_launches == sum(shapes.values()),
              f"{name}: dft_matmul launched {launches} times, line shapes "
              f"{lines}")
        rec = {"launches": launches, "line_shapes": lines}
        for be in ("matmul", "fft"):
            e, r = rel_err(torch, y, fn(be))
            check(r <= KERNEL_RTOL, f"{name}: cuda vs {be} route rel err "
                  f"{r:.3e} <= {KERNEL_RTOL:g}")
            rec[f"{be}_rel_err"] = r
        del y
        for be in ("cuda", "matmul", "fft"):
            rec[f"{be}_ms"] = time_ms(torch, lambda be=be: fn(be), reps=5)
        print(f"  {name}: " + ", ".join(
            f"{be} {rec[f'{be}_ms']:.3f} ms" for be in
            ("cuda", "matmul", "fft")) + " per call (mean of 5)",
            flush=True)
        out[name] = rec
    return out


# ------------------------------------------------------------ the LM path
def lm_tensors(model, cache) -> list:
    """Every tensor of a model and its cache (nested dicts)."""
    out = list(model.parameters())
    todo = [cache]
    while todo:
        for v in todo.pop().values():
            (todo if isinstance(v, dict) else out).append(v)
    return out


def check_on_card(torch, what, model, cache) -> None:
    ts = lm_tensors(model, cache)
    check(all(t.device.type == "cuda" for t in ts),
          f"{what}: all {len(ts)} tensors of the model and its cache on cuda")


def teacher_forced_errors(torch, bundle, model, cfg, batch, prefix: int,
                          cache_dtype, full) -> float:
    """Prefill ``prefix`` tokens of ``batch``, then decode the rest one by
    one; the largest |logit - full[position]| over every step, relative to
    the largest |full|.  ``full``: the teacher-forced forward's logits."""
    from repro_torch.models.transformer import logits_fn
    tokens = batch["tokens"]
    B, S = tokens.shape
    extra = cfg.n_img_tokens if cfg.family == "vlm" else 0
    with torch.inference_mode():
        if full is None:
            full = logits_fn(model, bundle.forward(model, batch), cfg)
        cache = bundle.init_cache(B, S + extra, cache_dtype)
        check_on_card(torch, cfg.name, model, cache)
        lg, cache = bundle.prefill(
            model, dict(batch, tokens=tokens[:, :prefix]), cache)
        err = (lg[:, 0] - full[:, extra + prefix - 1]).abs().max()
        lengths = torch.full((B,), prefix + extra, dtype=torch.long,
                             device=tokens.device)
        for t in range(prefix, S):
            lg, cache = bundle.decode(model, tokens[:, t:t + 1], cache,
                                      lengths)
            lengths += 1
            err = torch.maximum(
                err, (lg[:, 0] - full[:, extra + t]).abs().max())
        return float(err) / float(full.abs().max())


def lm_batch(torch, cfg, rng, B: int, S: int, dev) -> dict:
    """Tokens (and the stub frontends' embeddings) from ``rng``."""
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                             device=dev)
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.as_tensor(0.1 * rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)), dtype=torch.float32,
            device=dev)
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(0.1 * rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)), dtype=torch.float32, device=dev)
    return batch


def timed(torch, dev, fn, record):
    """``fn`` with its host-clock ms (between synchronizations) appended
    to ``record`` with the call's sequence length."""
    def run(params, arg, *rest):
        tokens = arg["tokens"] if isinstance(arg, dict) else arg
        sync(torch, dev)
        t0 = time.perf_counter()
        out = fn(params, arg, *rest)
        sync(torch, dev)
        record.append((tokens.shape[1], (time.perf_counter() - t0) * 1e3))
        return out
    return run


def serve_pass(torch, dev, bundle, model, cfg, prompts) -> dict:
    """One pass of LM_REQUESTS requests through a new ServeEngine: ms per
    prefill (by prompt length) and per decode step, tokens/s, peak
    memory."""
    import dataclasses
    from repro_torch.serve.engine import Request, ServeEngine
    prefills, decodes = [], []
    spied = dataclasses.replace(
        bundle, prefill=timed(torch, dev, bundle.prefill, prefills),
        decode=timed(torch, dev, bundle.decode, decodes))
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    eng = ServeEngine(spied, slots=LM_SLOTS, capacity=LM_CAPACITY,
                      cache_dtype=torch.bfloat16)
    eng.load(model)
    check_on_card(torch, f"{cfg.name} engine", model, eng.cache)
    reqs = [Request(rid=i, prompt=p, max_new=LM_NEW)
            for i, p in enumerate(prompts)]
    sync(torch, dev)
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    sync(torch, dev)
    wall = time.perf_counter() - t0
    check(all(r.done and len(r.out) == LM_NEW
              and all(0 <= t < cfg.vocab for t in r.out) for r in reqs),
          f"{cfg.name}: every request finished with {LM_NEW} tokens in "
          f"[0, {cfg.vocab})")
    steps = sorted(ms for _, ms in decodes)
    return {"wall_s": wall, "decode_steps": len(steps),
            "tokens_per_s": len(reqs) * LM_NEW / wall,
            "prefill_ms_by_len": sorted(prefills),
            "decode_ms_p50": steps[len(steps) // 2],
            "decode_ms_p99": steps[min(len(steps) - 1,
                                       int(0.99 * len(steps)))],
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "allocated_before_gib": before / 2**30}, eng


def decode_step_trace(torch, dev, bundle, model, eng) -> dict:
    """One decode step of the engine's batch under torch.profiler: aten
    ops (host trace), CUDA kernels and their summed device time (device
    trace; None when the profiler saw no device events)."""
    from torch.profiler import ProfilerActivity, profile
    toks = torch.zeros((LM_SLOTS, 1), dtype=torch.long, device=dev)
    with torch.inference_mode():
        bundle.decode(model, toks, eng.cache, eng.lengths)
        sync(torch, dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            bundle.decode(model, toks, eng.cache, eng.lengths)
            sync(torch, dev)
    evs = prof.events()
    kernels = [e for e in evs
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in evs if e.device_type == torch.autograd.DeviceType.CPU
           and e.name.startswith("aten::") and e.cpu_parent is None]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return {"aten_ops": len(ops), "cuda_kernels": len(kernels) or None,
            "kernel_ms": busy if kernels else None}


def serve_full_width(torch, dev, gpu, arch, passes) -> dict:
    """``arch`` at its published config (bf16), random weights from a
    seeded generator on the card, served once per name in ``passes``;
    then the same weights in fp32 against the teacher-forced forward."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models.model_zoo import build
    from repro_torch.models.transformer import logits_fn
    cfg = get_config(arch)
    bundle = build(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    with torch.inference_mode():
        model = bundle.init(gen)
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    est = cfg.param_count()
    check(abs(n - est) / n <= LM_PARAM_RTOL,
          f"{arch}: {n:,} parameters vs param_count() {est:,} "
          f"(within {LM_PARAM_RTOL:.0%})")
    rng = np.random.default_rng(SEED)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, int(L)) for L in lens]
    out = {"params": n, "param_count": est, "weights_gib": nbytes / 2**30,
           "init_s": init_s, "prompt_lens": lens.tolist(),
           "decode_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    for name in passes:
        rec, eng = serve_pass(torch, dev, bundle, model, cfg, prompts)
        out[name] = rec
        print(f"  {arch} {name}: prefill ms by prompt length "
              + ", ".join(f"{L}: {ms:.1f}" for L, ms in
                          rec["prefill_ms_by_len"])
              + f"; decode step p50 {rec['decode_ms_p50']:.2f} ms, p99 "
              f"{rec['decode_ms_p99']:.2f} ms over {rec['decode_steps']} "
              f"steps ({LM_SLOTS} slots); {rec['tokens_per_s']:.1f} "
              f"generated tokens/s; peak {rec['peak_gib']:.2f} GiB, "
              f"{rec['allocated_before_gib']:.2f} of it allocated before the "
              f"pass ({gpu})", flush=True)
    t0 = time.perf_counter()
    out["decode_step"] = decode_step_trace(torch, dev, bundle, model, eng)
    out["trace_s"] = time.perf_counter() - t0
    del eng
    print(f"  {arch}: one decode step of {LM_SLOTS} slots runs "
          f"{out['decode_step']['aten_ops']} aten ops and "
          f"{out['decode_step']['cuda_kernels']} CUDA kernels "
          f"({out['decode_step']['kernel_ms']} ms of kernel time); "
          f"weights {out['weights_gib']:.2f} GiB, read once per step: "
          f"bound {out['decode_bound_ms']:.3f} ms at 3.35 TB/s ({gpu})",
          flush=True)

    # agreement at full width: fp32, TF32 off, nothing dropped
    t0 = time.perf_counter()
    over = {"dtype": "float32"}
    if cfg.family == "moe":
        over["capacity_factor"] = float(cfg.n_experts)
    cfg32 = dataclasses.replace(cfg, **over)
    b32 = build(cfg32, device=dev)
    with torch.inference_mode():
        m32 = b32.init(None)
        m32.load_state_dict(model.state_dict())
    batch = lm_batch(torch, cfg, rng, LM_AGREE_B, 2 * LM_AGREE_PREFIX, dev)
    with torch.inference_mode():
        full = logits_fn(m32, b32.forward(m32, batch), cfg32)
    rel = teacher_forced_errors(torch, b32, m32, cfg32, batch,
                                LM_AGREE_PREFIX, torch.float32, full)
    check(rel <= LM_RTOL,
          f"{arch} fp32: prefill {LM_AGREE_PREFIX} + decode "
          f"{LM_AGREE_PREFIX} steps (B={LM_AGREE_B}) vs the teacher-forced "
          f"forward, max error {rel:.3e} of the largest |logit| <= "
          f"{LM_RTOL:g}")
    bf = build(dataclasses.replace(cfg, capacity_factor=cfg32.capacity_factor),
               device=dev)
    rel_bf16 = teacher_forced_errors(torch, bf, model, cfg, batch,
                                     LM_AGREE_PREFIX, torch.bfloat16, full)
    print(f"  {arch} bf16 weights and cache, same steps, vs the fp32 "
          f"forward: max error {rel_bf16:.3e} of the largest |logit| "
          "(report only)", flush=True)
    out["fp32_rel_err"], out["bf16_rel_err"] = rel, rel_bf16
    if cfg.family == "ssm":
        b_fft = build(dataclasses.replace(cfg32, conv_impl="fft"),
                      device=dev)
        with torch.inference_mode():
            h_dir = b32.forward(m32, batch)
            h_fft = b_fft.forward(m32, batch)
        err = float((h_fft - h_dir).abs().max())
        ok = bool(torch.allclose(h_fft, h_dir, rtol=LM_FFT_TOL,
                                 atol=LM_FFT_TOL))
        check(ok, f"{arch} fp32 forward, conv_impl='fft' (fft_conv, "
              f"'fft' backend) vs 'direct': max |diff| {err:.3e}, within "
              f"rtol = atol = {LM_FFT_TOL:g}")
        out["fft_conv_max_abs_diff"] = err
    out["agreement_s"] = time.perf_counter() - t0
    del model, m32, full
    torch.cuda.empty_cache()
    return out


def check_lm(torch, dev, gpu) -> dict:
    """The LM phase (see the module docstring)."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models.model_zoo import build
    out = {}
    for arch, passes in LM_SERVED:
        t0 = time.perf_counter()
        out[arch] = serve_full_width(torch, dev, gpu, arch, passes)
        out[arch]["seconds"] = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    for arch in LM_REDUCED:
        cfg = get_config(arch).reduced()
        bundle = build(cfg, device=dev)
        with torch.inference_mode():
            model = bundle.init(torch.Generator(device=dev).manual_seed(
                SEED))
        batch = lm_batch(torch, cfg, rng, 2, 16, dev)
        rel = teacher_forced_errors(torch, bundle, model, cfg, batch, 8,
                                    torch.float32, None)
        check(rel <= LM_RTOL,
              f"{cfg.name} ({cfg.family}, fp32): prefill 8 + decode 8 vs "
              f"teacher-forced, max error {rel:.3e} of the largest "
              f"|logit| <= {LM_RTOL:g}")
        out[cfg.name] = {"rel_err": rel}
    return out


# ---------------------------------------------------------- the train path
def train_tensors(params, opt) -> list:
    """Every tensor of a model and its optimizer state."""
    out = list(params.parameters())
    for v in opt.values():
        out.extend(v.values() if isinstance(v, dict) else [v])
    return out


def fixed_batch_trainer(trainer):
    """Every step on the step-0 batch, as the launcher's --fixed-batch."""
    batch_at = type(trainer.pipeline).batch_at
    trainer.pipeline.batch_at = lambda step: batch_at(trainer.pipeline, 0)
    return trainer


def timed_calls(obj, name, record):
    """Wrap ``obj.name`` to append each call's host seconds to
    ``record``."""
    fn = getattr(obj, name)

    def run(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        record.append(time.perf_counter() - t0)
        return out
    setattr(obj, name, run)


def profile_train_step(torch, dev, step_fn, params, opt, batch) -> dict:
    """One train step under torch.profiler: its CUDA kernels and their
    summed time, its top-level aten ops, and the ten aten ops with the
    most self device time (name, calls, ms)."""
    from torch.profiler import ProfilerActivity, profile
    sync(torch, dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, opt, met = step_fn(params, opt, batch)
        float(met["loss"])
    evs = prof.events()
    kernels = [e for e in evs
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in evs if e.device_type == torch.autograd.DeviceType.CPU
           and e.name.startswith("aten::") and e.cpu_parent is None]
    avg = sorted(prof.key_averages(),
                 key=lambda a: a.self_device_time_total, reverse=True)
    return {"kernels": len(kernels), "aten_ops": len(ops),
            "kernel_ms": sum(e.time_range.elapsed_us()
                             for e in kernels) / 1e3,
            "top": [(a.key, a.count, a.self_device_time_total / 1e3)
                    for a in avg[:10]]}


def state_spies(torch, seen: dict):
    """Wrap ``torch.autograd.grad`` and ``adamw.apply_updates`` for one
    train step: ``seen`` gets the bytes (and devices) of the first
    microbatch's gradients and of the float32 accumulator the step hands
    the optimizer.  Returns a function that removes the wrappers."""
    import repro_torch.optim.adamw as adamw
    grad, apply = torch.autograd.grad, adamw.apply_updates

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def grad_spy(*args, **kw):
        out = grad(*args, **kw)
        if "grads" not in seen:
            seen["grads"] = nbytes(out)
            seen["devices"] = sorted({t.device.type for t in out})
        return out

    def apply_spy(params, grads, state, cfg):
        seen["accumulator"] = nbytes(grads.values())
        seen["accumulator_dtypes"] = sorted({str(t.dtype)
                                             for t in grads.values()})
        return apply(params, grads, state, cfg)

    torch.autograd.grad, adamw.apply_updates = grad_spy, apply_spy

    def remove():
        torch.autograd.grad, adamw.apply_updates = grad, apply
    return remove


def train_tinyllama(torch, dev, gpu) -> dict:
    """TinyLlama-1.1B at its published config through Trainer: train,
    checkpoint, resume, serve the restored weights."""
    import math
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model_zoo import build, load_tree
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config(TRAIN_ARCH)
    bundle = build(cfg, device=dev)
    root = os.path.join(HERE, "build")
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free / 2**30
    print(f"  checkpoint directory under {root}: {free:.1f} GiB free, "
          f"2 x {TRAIN_CKPT_GIB} GiB needed", flush=True)
    check(free >= 2.1 * TRAIN_CKPT_GIB,
          f"{free:.1f} GiB of free disk for two {TRAIN_CKPT_GIB} GiB "
          "checkpoints (the resumed run's commits beside the first) with "
          "5% to spare")
    ckpt = tempfile.mkdtemp(prefix="train_ckpt_", dir=root)
    dcfg = DataConfig(vocab=cfg.vocab, seq=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                       total_steps=TRAIN_RESUME_STEPS)
    out = {"config": {"layers": cfg.n_layers, "d_model": cfg.d_model,
                      "heads": cfg.n_heads, "kv": cfg.n_kv,
                      "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                      "dtype": cfg.dtype, "remat": cfg.remat,
                      "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                      "microbatches": TRAIN_MB}}
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        tcfg = TrainerConfig(total_steps=TRAIN_STEPS, ckpt_every=1000,
                             ckpt_keep=1, log_every=1,
                             microbatches=TRAIN_MB, ckpt_dir=ckpt)
        tr = fixed_batch_trainer(Trainer(bundle, ocfg, tcfg, dcfg))
        saves, restores = [], []
        timed_calls(tr.ckpt, "save", saves)
        params, opt = tr.run()
        sync(torch, dev)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        n = sum(p.numel() for p in params.parameters())
        ts = train_tensors(params, opt)
        check(all(t.device.type == "cuda" for t in ts),
              f"{TRAIN_ARCH}: all {len(ts)} tensors of the model and its "
              "optimizer state on cuda")
        state = {"params_and_opt": sum(t.numel() * t.element_size()
                                       for t in ts)}
        del ts
        # the profiled step also reads, on the card, the bytes of the
        # gradients and of the float32 accumulator (the dry run's
        # calibration holds its state bytes to these)
        remove = state_spies(torch, state)
        try:
            out["profile"] = profile_train_step(
                torch, dev, tr.step_fn, params, opt,
                {k: torch.from_numpy(v).to(dev)
                 for k, v in tr.pipeline.batch_at(0).items()})
        finally:
            remove()
        check(state["devices"] == ["cuda"] and
              state["accumulator_dtypes"] == ["torch.float32"],
              f"{TRAIN_ARCH}: gradients on {state['devices']}, accumulator "
              f"{state['accumulator_dtypes']}")
        out["state_bytes_on_card"] = state
        del params, opt
        torch.cuda.empty_cache()
        losses = [h["loss"] for h in tr.history]
        dts = [h["dt"] for h in tr.history]
        steady = sum(dts[1:]) / len(dts[1:])
        step_dir = os.path.join(ckpt, f"step_{TRAIN_STEPS:08d}")
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))
        est = (2 * 2 * n + 4 * n + 8 * n) / 2**30
        prof = out["profile"]
        print(f"  one more step under torch.profiler: {prof['kernels']} "
              f"CUDA kernels, {prof['kernel_ms']:.1f} ms of kernel time "
              f"against the steady {steady * 1e3:.1f} ms step (device busy "
              f"{prof['kernel_ms'] / (steady * 1e3):.0%}); "
              f"{prof['aten_ops']} aten ops; by self device time: "
              + "; ".join(f"{k} x{c} {ms:.1f} ms" for k, c, ms in
                          prof["top"]), flush=True)
        out.update({"params": n, "losses": losses,
                    "step_ms": [d * 1e3 for d in dts],
                    "steady_step_ms": steady * 1e3,
                    "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady,
                    "peak_gib": peak, "allocated_before_gib": before / 2**30,
                    "state_estimate_gib": est,
                    "ckpt_bytes": nbytes, "ckpt_write_s": saves[-1]})
        print(f"  {TRAIN_ARCH} ({n:,} parameters, bf16, remat "
              f"{cfg.remat!r}, {TRAIN_BATCH}x{TRAIN_SEQ} tokens in "
              f"{TRAIN_MB} microbatches): step ms "
              + ", ".join(f"{d * 1e3:.1f}" for d in dts)
              + f"; steady {steady * 1e3:.1f} ms, "
              f"{out['tokens_per_s']:.0f} tokens/s; peak {peak:.2f} GiB "
              f"({before / 2**30:.2f} allocated before) against "
              f"{est:.2f} GiB of weights, gradients, f32 accumulator and "
              f"moments plus activations; checkpoint {nbytes / 2**30:.2f} "
              f"GiB written in {saves[-1]:.1f} s ({gpu})", flush=True)
        print("  loss curve: " + ", ".join(f"{x:.4f}" for x in losses),
              flush=True)
        check(all(math.isfinite(x) for x in losses),
              f"{TRAIN_ARCH}: every loss finite")
        check(losses[-1] < losses[0],
              f"{TRAIN_ARCH}: the loss fell ({losses[0]:.4f} -> "
              f"{losses[-1]:.4f})")
        check(abs(losses[0] - math.log(cfg.vocab)) <= 1.0,
              f"{TRAIN_ARCH}: first loss {losses[0]:.4f} within 1.0 of "
              f"ln {cfg.vocab} = {math.log(cfg.vocab):.4f}")
        check(tr.ckpt.latest_step() == TRAIN_STEPS,
              f"checkpoint committed at step {TRAIN_STEPS}")

        tcfg2 = TrainerConfig(total_steps=TRAIN_RESUME_STEPS,
                              ckpt_every=1000, ckpt_keep=1, log_every=1,
                              microbatches=TRAIN_MB, ckpt_dir=ckpt)
        tr2 = fixed_batch_trainer(Trainer(bundle, ocfg, tcfg2, dcfg))
        timed_calls(tr2.ckpt, "restore", restores)
        params, opt = tr2.run()
        del params, opt
        torch.cuda.empty_cache()
        resumed = [h["loss"] for h in tr2.history]
        out.update({"resumed_first_step": tr2.history[0]["step"],
                    "resumed_losses": resumed,
                    "ckpt_restore_s": restores[0]})
        print(f"  resumed at step {tr2.history[0]['step']} (restore "
              f"{restores[0]:.1f} s): losses "
              + ", ".join(f"{x:.4f}" for x in resumed), flush=True)
        check(tr2.history[0]["step"] == TRAIN_STEPS,
              f"the second Trainer resumed at step {TRAIN_STEPS}")
        check(all(math.isfinite(x) for x in resumed) and
              resumed[-1] < losses[0], "the resumed run's losses finite and "
              "below the first step's")

        t0 = time.perf_counter()
        step, tree = CheckpointManager(ckpt).restore()
        model = bundle.init(None)
        load_tree(model, tree["params"])
        del tree
        eng = ServeEngine(bundle, slots=1, capacity=64,
                          cache_dtype=torch.bfloat16)
        eng.load(model)
        check_on_card(torch, f"{TRAIN_ARCH} served", model, eng.cache)
        rng = np.random.default_rng(SEED)
        req = Request(rid=0, prompt=rng.integers(0, cfg.vocab, 8),
                      max_new=TRAIN_NEW)
        eng.submit(req)
        eng.run_until_done()
        out["served"] = {"step": step, "tokens": req.out,
                         "seconds": time.perf_counter() - t0}
        check(step == TRAIN_RESUME_STEPS and len(req.out) == TRAIN_NEW
              and all(0 <= t < cfg.vocab for t in req.out),
              f"served one request from the step-{step} checkpoint: "
              f"{TRAIN_NEW} tokens {req.out}")
        del model, eng
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def train_moe(torch, dev, gpu) -> dict:
    """Granite-MoE 3B-A800M's train step at its published config."""
    import math
    from repro_torch.configs.base import get_config
    from repro_torch.models.model_zoo import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import init_opt_state, make_train_step
    cfg = get_config(TRAIN_MOE)
    bundle = build(cfg, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = bundle.init(gen)
    opt = init_opt_state(params)
    n = sum(p.numel() for p in params.parameters())
    tokens = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device=dev)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    step = make_train_step(bundle, AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                               total_steps=8),
                           microbatches=TRAIN_MB)
    losses, ms = [], []
    for _ in range(TRAIN_MOE_STEPS):
        sync(torch, dev)
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    ts = train_tensors(params, opt)
    check(all(t.device.type == "cuda" for t in ts),
          f"{TRAIN_MOE}: all {len(ts)} tensors on cuda")
    del params, opt, ts, batch
    torch.cuda.empty_cache()
    # bf16 weights and a microbatch's gradients, the f32 accumulator, f32
    # m and v: 2 + 2 + 4 + 8 bytes a parameter
    est = 16 * n / 2**30
    tokens_mb = TRAIN_BATCH * TRAIN_SEQ // TRAIN_MB
    from repro_torch.models.moe import _capacity
    C = _capacity(tokens_mb, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    print(f"  {TRAIN_MOE} ({n:,} parameters, bf16, remat {cfg.remat!r}, "
          f"{tokens_mb} tokens a microbatch, expert capacity {C}): step "
          "ms " + ", ".join(f"{x:.1f}" for x in ms) + "; losses "
          + ", ".join(f"{x:.4f}" for x in losses) + f"; peak {peak:.2f} GiB "
          f"({before / 2**30:.2f} allocated before) against ~{est:.2f} GiB "
          f"of state plus activations ({gpu})", flush=True)
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{TRAIN_MOE}: losses finite and falling ({losses[0]:.4f} -> "
          f"{losses[-1]:.4f})")
    return {"params": n, "step_ms": ms, "losses": losses, "peak_gib": peak,
            "allocated_before_gib": before / 2**30, "capacity": C,
            "state_estimate_gib": est}


class watch_compression:
    """Record the float32 input of every ``compress_grads`` call of the
    train step (gradient plus residual, on the host) in ``seen``."""

    def __init__(self, seen):
        self.seen = seen

    def __enter__(self):
        from repro_torch.train import train_step
        self.mod, self.real = train_step, train_step.compress_grads

        def spy(grads, residuals, *rest):
            self.seen.append({n: (g.float() + residuals[n]).cpu()
                              for n, g in grads.items()})
            return self.real(grads, residuals, *rest)
        train_step.compress_grads = spy
        return self

    def __exit__(self, *exc):
        self.mod.compress_grads = self.real


def code_flips(torch, got: dict, want: dict) -> dict:
    """The int8 codes of two compression inputs compared: how many differ
    and by how many steps at most."""
    from repro_torch.optim.compression import _quantize
    n = diff = worst = 0
    for k, x in want.items():
        qa = _quantize(got[k])[0].int()
        qb = _quantize(x)[0].int()
        d = (qa - qb).abs()
        n += d.numel()
        diff += int((d > 0).sum())
        worst = max(worst, int(d.max()))
    return {"codes": n, "codes_differing": diff, "code_max_step": worst}


def grads_of(torch, bundle, model, batch) -> dict:
    """{name: gradient} of the bundle's loss on ``batch``, on the host."""
    model.zero_grad(set_to_none=True)
    loss = bundle.loss(model, batch)
    loss.backward()
    out = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), out


def grad_err(got: dict, want: dict) -> float:
    scale = max(float(w.abs().max()) for w in want.values())
    return max(float((got[k] - w).abs().max()) for k, w in want.items()) \
        / scale


def to_device(torch, batch, dev) -> dict:
    return {k: v.to(dev) for k, v in batch.items()}


def train_agreement(torch, dev) -> dict:
    """The six families reduced, fp32: the card against the port's CPU
    route (gradients on one step, two compressed train steps), then
    TinyLlama at published width cut to TRAIN_REMAT_LAYERS layers: the
    gradients under remat "full" and "dots" against "none"."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models.model_zoo import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import init_opt_state, make_train_step
    cpu = torch.device("cpu")
    out = {}
    rng = np.random.default_rng(SEED)
    for arch in TRAIN_FAMILIES:
        cfg = get_config(arch).reduced()
        bc, bd = build(cfg, device=cpu), build(cfg, device=dev)
        host = bc.init(torch.Generator().manual_seed(SEED))
        card = bd.init(None)
        with torch.no_grad():
            for p, q in zip(card.parameters(), host.parameters()):
                p.copy_(q)
        batch = lm_batch(torch, cfg, rng, 4, 32, cpu)
        batch["labels"] = torch.roll(batch["tokens"], -1, 1)
        lc, gc = grads_of(torch, bc, host, batch)
        ld, gd = grads_of(torch, bd, card, to_device(torch, batch, dev))
        rec = {"loss_rel": abs(ld - lc) / abs(lc),
               "grad_err": grad_err(gd, gc)}
        ocfg = AdamWConfig(lr=TRAIN_AGREE_LR, warmup_steps=1, total_steps=8)
        runs = {}
        for name, bundle, model, d in (("cpu", bc, host, cpu),
                                       ("cuda", bd, card, dev)):
            step = make_train_step(bundle, ocfg, microbatches=2,
                                   compress=True)
            opt = init_opt_state(model, compress=True)
            mets, seen = [], []
            b = to_device(torch, batch, d)
            with watch_compression(seen):
                for _ in range(2):
                    model, opt, met = step(model, opt, b)
                    mets.append((float(met["loss"]),
                                 float(met["grad_norm"])))
            runs[name] = (mets, {n: p.detach().cpu() for n, p in
                                 model.named_parameters()}, seen[0])
        (mc, pc, xc), (md, pd, xd) = runs["cpu"], runs["cuda"]
        rec["loss_rel_by_step"] = [abs(a[0] - b[0]) / abs(b[0])
                                   for a, b in zip(md, mc)]
        rec["grad_norm_rel_by_step"] = [abs(a[1] - b[1]) / abs(b[1])
                                        for a, b in zip(md, mc)]
        rec.update(code_flips(torch, xd, xc))
        diff = torch.cat([(pd[k] - pc[k]).abs().reshape(-1) for k in pc])
        rec["param_max_abs_diff"] = float(diff.max())
        rec["params"] = diff.numel()
        rec["params_beyond_1e-6"] = int((diff > 1e-6).sum())
        rec["params_beyond_lr_half"] = int((diff > TRAIN_AGREE_LR / 2).sum())
        out[arch] = rec
        print(f"  {cfg.name} ({cfg.family}, fp32, card vs CPU): loss "
              f"{rec['loss_rel']:.2e}, gradients {rec['grad_err']:.2e} of "
              "the largest; 2 compressed steps: loss "
              + ", ".join(f"{x:.2e}" for x in rec["loss_rel_by_step"])
              + ", grad_norm "
              + ", ".join(f"{x:.2e}" for x in rec["grad_norm_rel_by_step"])
              + f"; first step's int8 codes: {rec['codes_differing']} of "
              f"{rec['codes']} differ (by at most {rec['code_max_step']}); "
              f"parameters: max |diff| {rec['param_max_abs_diff']:.2e}, "
              f"{rec['params_beyond_1e-6']} of {rec['params']} beyond 1e-6, "
              f"{rec['params_beyond_lr_half']} beyond lr/2", flush=True)
        check(rec["loss_rel"] <= TRAIN_RTOL and
              rec["grad_err"] <= TRAIN_RTOL,
              f"{cfg.name}: loss and gradients on the card within "
              f"{TRAIN_RTOL:g} of the CPU route's")
        check(max(rec["loss_rel_by_step"]) <= TRAIN_RTOL,
              f"{cfg.name}: loss of 2 compressed steps within "
              f"{TRAIN_RTOL:g} relative")
        check(rec["code_max_step"] <= 1 and
              rec["codes_differing"] <= TRAIN_FLIP_SHARE * rec["codes"],
              f"{cfg.name}: the first step's int8 codes equal but at "
              f"rounding boundaries (each by one step, <= "
              f"{TRAIN_FLIP_SHARE:.1%} of them)")
        check(max(rec["grad_norm_rel_by_step"]) <= TRAIN_COMP_RTOL,
              f"{cfg.name}: grad_norm of 2 compressed steps within "
              f"{TRAIN_COMP_RTOL:g} relative (a flipped code moves its "
              "element by a whole quantisation step)")
        check(rec["param_max_abs_diff"] <= 2 * 2 * TRAIN_AGREE_LR and
              rec["params_beyond_lr_half"] <= TRAIN_FLIP_SHARE
              * rec["params"],
              f"{cfg.name}: parameters after 2 steps within 2·lr per step, "
              f"<= {TRAIN_FLIP_SHARE:.1%} of them beyond lr/2")
    # remat at published width, 2 layers, fp32
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32",
                              n_layers=TRAIN_REMAT_LAYERS)
    model = build(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    batch = lm_batch(torch, cfg, rng, TRAIN_REMAT_B, TRAIN_SEQ, dev)
    batch["labels"] = torch.roll(batch["tokens"], -1, 1)
    grads, peaks = {}, {}
    for remat in ("none", "full", "dots"):
        b = build(dataclasses.replace(cfg, remat=remat), device=dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        grads[remat] = grads_of(torch, b, model, batch)[1]
        peaks[remat] = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    rec = {r: grad_err(grads[r], grads["none"]) for r in ("full", "dots")}
    rec["peak_above_weights_gib"] = peaks
    out["remat"] = rec
    print(f"  {TRAIN_ARCH} published width, {TRAIN_REMAT_LAYERS} layers, "
          f"fp32, B={TRAIN_REMAT_B}, S={TRAIN_SEQ}: gradients under remat "
          f"'full' {rec['full']:.2e}, 'dots' {rec['dots']:.2e} of the "
          "largest against 'none'; peak above the weights "
          + ", ".join(f"{k} {v:.2f} GiB" for k, v in peaks.items()),
          flush=True)
    check(rec["full"] <= TRAIN_RTOL and rec["dots"] <= TRAIN_RTOL,
          f"remat 'full' and 'dots' gradients within {TRAIN_RTOL:g} of "
          "'none'")
    del model, grads
    torch.cuda.empty_cache()
    return out


def train_launcher(gpu) -> dict:
    """``python -m repro_torch.launch.train --preset 100m`` on the card."""
    import re
    import shutil
    import tempfile
    root = os.path.join(HERE, "build")
    ckpt = tempfile.mkdtemp(prefix="launch_ckpt_", dir=root)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--preset",
           "100m", "--steps", str(TRAIN_LAUNCHER_STEPS), "--fixed-batch",
           "--ckpt-dir", ckpt]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                              text=True, timeout=600, check=False)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    wall = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    m = re.match(r"first loss ([0-9.]+) -> last loss ([0-9.]+)", tail[0])
    print(f"  launcher --preset 100m, {TRAIN_LAUNCHER_STEPS} steps: "
          f"exit {proc.returncode}, {wall:.1f} s: {tail[0]} ({gpu})",
          flush=True)
    if proc.returncode:
        print(proc.stderr[-4000:], flush=True)
    check(proc.returncode == 0 and m is not None
          and float(m.group(2)) < float(m.group(1)),
          "the launcher trained the 100m preset on the card and its last "
          "loss is below its first")
    return {"first_loss": float(m.group(1)), "last_loss": float(m.group(2)),
            "seconds": wall}


def run_train(torch, dev, gpu, wrappers) -> dict:
    """The train phase with every kernel wrapper's count set to 0 just
    before it and read just after: the LM training path reaches no hand
    kernel (nor does the reference's any Pallas kernel)."""
    t0 = time.perf_counter()
    print(f"LM training path ({gpu}):", flush=True)
    for fn in wrappers.values():
        fn.launches = 0
    train = check_train(torch, dev, gpu)
    train["launches"] = {k: fn.launches for k, fn in wrappers.items()}
    check(not any(train["launches"].values()),
          "the LM training path launched no hand kernel: "
          f"{train['launches']}")
    print(f"train phase: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return train


def check_train(torch, dev, gpu) -> dict:
    """The train phase (see the module docstring)."""
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 off for the train phase's fp32 products")
    out = {}
    for name, fn in (("tinyllama", lambda: train_tinyllama(torch, dev, gpu)),
                     ("granite_moe", lambda: train_moe(torch, dev, gpu)),
                     ("agreement", lambda: train_agreement(torch, dev)),
                     ("launcher", lambda: train_launcher(gpu))):
        t0 = time.perf_counter()
        out[name] = fn()
        out[name]["seconds"] = time.perf_counter() - t0
        print(f"  {name}: {out[name]['seconds']:.1f} s", flush=True)
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "the train phase left TF32 off")
    return out


# ------------------------------------------------------ the placed train path
def _one_process_step(torch, dev, cfg, ocfg, batch, steps,
                      microbatches: int = TRAIN_MB):
    """One process's ``steps`` train steps of ``cfg`` from the weights
    drawn from SEED on ``dev``, in ``microbatches``: (losses, grad norms,
    the model, the first moment after the first step (host tensors): 1 -
    beta1 times its gradient)."""
    from repro_torch.models.model_zoo import build
    from repro_torch.train.train_step import init_opt_state, make_train_step
    bundle = build(cfg, device=dev)
    model = bundle.init(torch.Generator(device=dev).manual_seed(SEED))
    opt = init_opt_state(model)
    step = make_train_step(bundle, ocfg, microbatches=microbatches)
    losses, norms, first = [], [], None
    for _ in range(steps):
        model, opt, met = step(model, opt, batch)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        if first is None and steps > 1:
            first = {n: t.to("cpu", copy=True)
                     for n, t in opt["m"].items()}
    del opt
    return losses, norms, model, first


def tree_err(torch, got: dict, want: dict) -> tuple[float, str]:
    """(max |got - want| over the largest |want|, the tensor where it
    is)."""
    scale = max(float(v.abs().max()) for v in want.values())
    errs = {n: float((got[n].cpu() - want[n]).abs().max()) / scale
            for n in want}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def ckpt_gib(cfg) -> float:
    """GiB of a checkpoint of ``cfg``'s bf16 parameters and float32 m and
    v."""
    from repro_torch.models.model_zoo import build
    return 10 * sum(p.numel() for p in build(cfg, device="meta").init(
        None).parameters()) / 2**30


def shard_config(reduced: bool, arch: str = TRAIN_ARCH,
                 layers: int | None = None):
    """``arch``'s published config (cut to ``layers`` layers when given),
    or (a rehearsal on the CPU) its reduced config in bf16 with remat
    "full"."""
    import dataclasses
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    if reduced:
        return dataclasses.replace(cfg.reduced(), dtype="bfloat16",
                                   remat="full")
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def placed_trainer_run(torch, dev, tr):
    """Run the placed Trainer ``tr`` from SEED, counting each step's
    collective operand bytes and timing its checkpoint saves: (this
    rank's record: peak, placement, state bytes, history, bytes per step,
    the last save's seconds; the parameters; the optimizer state)."""
    from repro_torch.core.grid import collective_bytes
    from repro_torch.sharding import rules
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    counted, saves = [], []
    step_fn = tr.step_fn

    def step_counted(*args):
        collective_bytes(reset=True)
        res = step_fn(*args)
        counted.append(collective_bytes())
        return res
    tr.step_fn = step_counted
    timed_calls(tr, "_save", saves)
    params, opt = tr.run(torch.Generator(device=dev).manual_seed(SEED))
    sync(torch, dev)
    out = {"peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda
           else 0,
           "reserved_bytes": torch.cuda.max_memory_reserved(dev) if cuda
           else 0,
           "placed": rules.placement_of(params) is not None,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters()),
           "opt_bytes": sum(t.numel() * t.element_size() for k in ("m", "v")
                            for t in opt[k].values())
           + opt["step"].numel() * opt["step"].element_size(),
           "on_card": all(t.device == dev
                          for t in train_tensors(params, opt)),
           "history": [{k: h[k] for k in ("loss", "grad_norm", "dt")}
                       for h in tr.history],
           "collectives_per_step": counted}
    if saves:
        out["save_s"] = saves[-1]
    return out, params, opt


def host_state(params, opt) -> tuple[dict, dict]:
    """Host copies of the parameters and of the optimizer state."""
    return ({n: p.detach().cpu() for n, p in params.named_parameters()},
            {k: ({n: t.cpu() for n, t in v.items()}
                 if isinstance(v, dict) else v.cpu())
             for k, v in opt.items()})


def restore_into_blocks(torch, dev, trainer, mine, mine_opt) -> dict:
    """A new Trainer (``trainer()``) restored from the checkpoint the
    writer has committed (every rank waits for it), against this rank's
    blocks ``mine``/``mine_opt`` (:func:`host_state`) as it saved them:
    seconds, the step restored, and whether the blocks came back bitwise
    at this rank's local shapes."""
    import torch.distributed as dist
    dist.barrier()                      # the writer has committed
    tr2 = trainer()
    t0 = time.perf_counter()
    start, params, opt = tr2._restore_or_init(None)
    sync(torch, dev)
    out = {"restore_s": time.perf_counter() - t0, "restored_step": start,
           "restored_bitwise": all(
               torch.equal(p.detach().cpu(), mine[n])
               for n, p in params.named_parameters()) and all(
               torch.equal(opt[k][n].cpu(), mine_opt[k][n])
               for k in ("m", "v") for n in mine) and
           torch.equal(opt["step"].cpu(), mine_opt["step"]),
           "restored_local": all(
               tuple(p.shape) == tuple(mine[n].shape)
               for n, p in params.named_parameters())}
    del params, opt, tr2
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def sharded_train_rank(rank, job):
    """One rank of the sharded_train phase (a spawned process of
    ``run_ranks``): the placed Trainer at full width, its checkpoint
    restored into blocks, then the float32 depth-cut run.  It measures
    and compares; the parent makes every check."""
    import dataclasses
    import torch

    from repro_torch.core.grid import ProcGrid
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import sphere_pack
    from repro_torch.kernels.dft_matmul import dft_matmul, \
        dft_matmul_twiddle
    from repro_torch.models.model_zoo import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import ctx
    from repro_torch.train.trainer import Trainer, TrainerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    wrappers = (dft_matmul, dft_matmul_twiddle, sphere_pack.unpack_dft,
                sphere_pack.dft_pack)
    for fn in wrappers:
        fn.launches = 0
    grid = ProcGrid.create(SHARD_GRID, SHARD_AXES, device=dev)
    cfg = shard_config(job["reduced"], layers=SHARD_LAYERS)
    dcfg = DataConfig(vocab=cfg.vocab, seq=job["seq"],
                      global_batch=job["batch"])
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                       total_steps=TRAIN_RESUME_STEPS)
    out = {"coordinate": grid.coordinate}
    with ctx.use(grid, ("data",)):
        bundle = build(cfg, device=dev)

        def trainer():
            return fixed_batch_trainer(Trainer(bundle, ocfg, TrainerConfig(
                total_steps=SHARD_STEPS, ckpt_every=1000, ckpt_keep=1,
                log_every=1000, microbatches=TRAIN_MB,
                ckpt_dir=job["ckpt"]), dcfg, grid=grid))
        rec, params, opt = placed_trainer_run(torch, dev, trainer())
        out.update(rec)
        mine = host_state(params, opt)
        del params, opt
        out.update(restore_into_blocks(torch, dev, trainer, *mine))
        del mine

        out["exact"] = placed_exact_run(
            torch, grid, dataclasses.replace(
                cfg, dtype="float32", n_layers=SHARD_EXACT_LAYERS), dcfg,
            job, rank, SHARD_EXACT_STEPS)
    out["launches"] = {fn.__name__: fn.launches for fn in wrappers}
    return out


def placed_exact_run(torch, grid, c32, dcfg, job, rank, steps, tape=None,
                     extra=None, microbatches: int = TRAIN_MB):
    """``steps`` float32 steps of ``c32`` on weights placed on ``grid``
    (drawn from SEED), this rank's rows of the batch at step 0 (and of
    ``extra``, whole-batch tensors such as frames) in ``microbatches``:
    losses and grad norms; on rank 0 the gathered parameters' and the
    first step's first moment's errors against one process's
    (``job["exact_params"]``).  ``tape``: a context the steps run in."""
    import contextlib
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.models.model_zoo import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import rules
    from repro_torch.train.train_step import init_opt_state, make_train_step
    dev = grid.device
    b32 = build(c32, device=dev)
    model = b32.init(torch.Generator(device=dev).manual_seed(SEED))
    rules.place_params(model, grid)
    opt = init_opt_state(model)
    step = make_train_step(b32, AdamWConfig(
        lr=TRAIN_AGREE_LR, warmup_steps=1, total_steps=TRAIN_STEPS),
        grid, microbatches=microbatches)
    d = grid.axis_index("data")
    pipe = Pipeline(dcfg, grid.coordinate[d], grid.shape[d])
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(0).items()}
    rows = slice(grid.coordinate[d] * pipe.local_batch,
                 (grid.coordinate[d] + 1) * pipe.local_batch)
    batch.update({k: v[rows] for k, v in (extra or {}).items()})
    losses, norms, first = [], [], None
    with tape or contextlib.nullcontext():
        for _ in range(steps):
            model, opt, met = step(model, opt, batch)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
            if first is None:
                first = rules.gather_named(model, opt["m"], device="cpu",
                                           keep=rank == 0)
    whole = rules.gather_params(model)
    out = {"losses": losses, "norms": norms}
    if rank == 0:
        ref = torch.load(job["exact_params"])
        out["param_err"] = tree_err(torch, whole, ref["params"])
        out["first_moment_err"] = tree_err(torch, first, ref["m1"])
    return out


def run_sharded_train(torch, dev, gpu, wrappers) -> dict:
    """The sharded_train phase (see SHARD_*): one process's references in
    this process, then SHARD_PROCS ranks, with every kernel wrapper's
    count set to 0 just before and read just after (the path reaches no
    hand kernel)."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.core.grid import ProcGrid
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch.dryrun import model_collectives, param_leaves, \
        state_bytes
    from repro_torch.models.model_zoo import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding.procs import run_ranks
    t0 = time.perf_counter()
    print(f"placed train path ({SHARD_TAG}; gloo carries each collective "
          "through host memory: per-rank state, agreement and bytes, no "
          f"scaling number): grid {SHARD_GRID} {SHARD_AXES}; card {gpu}",
          flush=True)
    for fn in wrappers.values():
        fn.launches = 0
    cfg = shard_config(SHARD_REDUCED, layers=SHARD_LAYERS)
    dcfg = DataConfig(vocab=cfg.vocab, seq=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in Pipeline(dcfg).batch_at(0).items()}
    os.makedirs(SHARD_DIR, exist_ok=True)
    free = shutil.disk_usage(SHARD_DIR).free / 2**30
    need = ckpt_gib(cfg)
    check(free >= 1.05 * need,
          f"{free:.1f} GiB of free disk for the {need:.2f} GiB checkpoint "
          "with 5% to spare")
    # one process: the first full-width step, the float32 depth-cut run
    torch.cuda.empty_cache()
    lw, nw, model, _ = _one_process_step(
        torch, dev, cfg, AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                     total_steps=TRAIN_RESUME_STEPS),
        batch, 1)
    del model
    torch.cuda.empty_cache()
    c32 = dataclasses.replace(cfg, dtype="float32",
                              n_layers=SHARD_EXACT_LAYERS)
    o32 = AdamWConfig(lr=TRAIN_AGREE_LR, warmup_steps=1,
                      total_steps=TRAIN_STEPS)
    l32, n32, model, m32 = _one_process_step(torch, dev, c32, o32, batch,
                                             SHARD_EXACT_STEPS)
    exact = {n: p.detach().cpu() for n, p in model.named_parameters()}
    del model
    # the same run again: how far one process is from itself (the
    # embedding's backward adds with atomics on the card)
    _, _, model, again = _one_process_step(torch, dev, c32, o32, batch,
                                           SHARD_EXACT_STEPS)
    self_err = {"params": tree_err(torch, {n: p.detach() for n, p in
                                           model.named_parameters()},
                                   exact),
                "first_moment": tree_err(torch, again, m32)}
    exact_path = os.path.join(SHARD_DIR, "exact_params.pt")
    torch.save({"params": exact, "m1": m32}, exact_path)
    del model, batch, exact, m32, again
    torch.cuda.empty_cache()
    ckpt = tempfile.mkdtemp(prefix="sharded_ckpt_", dir=SHARD_DIR)
    job = {"device": str(dev), "ckpt": ckpt, "exact_params": exact_path,
           "reduced": SHARD_REDUCED, "seq": TRAIN_SEQ,
           "batch": TRAIN_BATCH}
    t1 = time.perf_counter()
    try:
        ranks = run_ranks(sharded_train_rank, SHARD_PROCS, args=(job,),
                          rendezvous_dir=SHARD_DIR, timeout=SHARD_TIMEOUT,
                          threads=SHARD_THREADS)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        os.remove(exact_path)
    ranks_s = time.perf_counter() - t1

    agrid = ProcGrid.create_abstract(SHARD_GRID, SHARD_AXES)
    leaves = param_leaves(build(cfg, device="meta").init(None), agrid)
    acct = state_bytes(leaves, agrid, kind="train", microbatches=TRAIN_MB)
    model_coll = model_collectives(
        cfg, "train", leaves, agrid, batch=TRAIN_BATCH // SHARD_GRID[0],
        seq=TRAIN_SEQ, microbatches=TRAIN_MB, batch_split=True)
    out = {"one_process": {"loss": lw[0], "grad_norm": nw[0],
                           "exact_losses": l32, "exact_norms": n32},
           "accounting": acct, "model_collectives": model_coll,
           "ranks_s": ranks_s, "ranks": ranks}
    for r, o in enumerate(ranks):
        h = o["history"]
        dts = [x["dt"] for x in h]
        steady = sum(dts[1:]) / len(dts[1:])
        o["steady_step_ms"] = steady * 1e3
        print(f"  rank {r} {o['coordinate']}: parameters "
              f"{o['param_bytes']:,} B, AdamW state {o['opt_bytes']:,} B "
              f"(accounting {acct['params']:,} and {acct['opt_state']:,});"
              f" peak {_gib(o['peak_bytes'] / 2**30)}; step ms "
              + ", ".join(f"{d * 1e3:.1f}" for d in dts)
              + f", steady {steady * 1e3:.1f} ({SHARD_TAG}, {gpu}); "
              f"losses " + ", ".join(f"{x['loss']:.5f}" for x in h)
              + f"; checkpoint save {o['save_s']:.1f} s, restore "
              f"{o['restore_s']:.1f} s", flush=True)
        check(o["placed"] and o["on_card"],
              f"rank {r}: weights placed, every tensor on {dev}")
        check(o["param_bytes"] == acct["params"] and
              o["opt_bytes"] == acct["opt_state"],
              f"rank {r}: parameter and AdamW state bytes equal the dry "
              f"run's state_bytes on the abstract {SHARD_GRID} grid to the "
              "byte")
        check(o["restored_step"] == SHARD_STEPS and o["restored_bitwise"]
              and o["restored_local"],
              f"rank {r}: the step-{SHARD_STEPS} checkpoint (whole tensors)"
              " restored into this rank's blocks, bitwise")
        check(o["history"][0]["loss"] == ranks[0]["history"][0]["loss"],
              f"rank {r}: the same loss as rank 0")
    print("  collective operand bytes per step and device (counted on rank "
          "0, step 1) vs the dry run's model_collectives: " + ", ".join(
              f"{k} {ranks[0]['collectives_per_step'][0].get(k, 0):,} vs "
              f"{model_coll[k]:,}" for k in model_coll), flush=True)
    check(all(o["collectives_per_step"][0] == o["collectives_per_step"][-1]
              for o in ranks),
          "every step runs the same collectives")
    first = ranks[0]["history"][0]
    dl = abs(first["loss"] - lw[0]) / abs(lw[0])
    dg = abs(first["grad_norm"] - nw[0]) / abs(nw[0])
    out["full_width_agreement"] = {"loss_rel": dl, "grad_norm_rel": dg}
    check(dl <= SHARD_LOSS_RTOL and dg <= SHARD_GNORM_RTOL,
          f"{TRAIN_ARCH} bf16 placed vs one process, first step: loss "
          f"{first['loss']:.6f} vs {lw[0]:.6f} ({dl:.2e} <= "
          f"{SHARD_LOSS_RTOL:g}), grad_norm {first['grad_norm']:.6f} vs "
          f"{nw[0]:.6f} ({dg:.2e} <= {SHARD_GNORM_RTOL:g})")
    ex = ranks[0]["exact"]
    el = max(abs(a - b) / abs(b) for a, b in zip(ex["losses"], l32))
    en = max(abs(a - b) / abs(b) for a, b in zip(ex["norms"], n32))
    out["exact_agreement"] = {"loss_rel": el, "grad_norm_rel": en,
                              "param_err": ex["param_err"],
                              "first_moment_err": ex["first_moment_err"],
                              "one_process_vs_itself": self_err}
    print(f"  float32: one process against itself (the same run twice): "
          f"parameters {self_err['params'][0]:.2e} of the largest (at "
          f"{self_err['params'][1]}), first moment "
          f"{self_err['first_moment'][0]:.2e} (at "
          f"{self_err['first_moment'][1]})", flush=True)
    check(el <= SHARD_EXACT_RTOL and en <= SHARD_EXACT_RTOL and
          ex["first_moment_err"][0] <= SHARD_EXACT_RTOL and
          ex["param_err"][0] <= SHARD_EXACT_PARAM,
          f"{TRAIN_ARCH} float32, {SHARD_EXACT_LAYERS} layers, "
          f"{SHARD_EXACT_STEPS} steps, placed vs one process: loss "
          f"{el:.2e}, grad_norm {en:.2e}, the first step's gradient "
          f"(first moment) {ex['first_moment_err'][0]:.2e} of its largest "
          f"(at {ex['first_moment_err'][1]}) <= {SHARD_EXACT_RTOL:g}; "
          f"parameters {ex['param_err'][0]:.2e} of the largest (at "
          f"{ex['param_err'][1]}) <= {SHARD_EXACT_PARAM:g}")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    for o in ranks:
        for k, v in o["launches"].items():
            launches[k] += v
    out["launches"] = launches
    check(not any(launches.values()),
          f"the placed train path launched no hand kernel: {launches}")
    out["seconds"] = time.perf_counter() - t0
    print(f"sharded_train phase: {out['seconds']:.1f} s (ranks "
          f"{ranks_s:.1f} s)", flush=True)
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------- the expert-parallel path
def batch_ranks(grid) -> int:
    """The processes of ``grid``'s batch axes ("pod", "data"): with one,
    no gradient is all-reduced over them."""
    return math.prod(grid.shape[grid.axis_index(x)] for x in ("pod", "data")
                     if x in grid.axes)


def model_split_of(leaves):
    """``split(key, dim)``: whether "model" splits dim ``dim`` (of the
    layer's own dims: 0 or 1) of the leaf whose path ends in ``key`` (its
    last two names; a top-level leaf's one name)."""
    specs = {lf["path"][-2:] if _stacked_leaf(lf) else lf["path"][:1]:
             lf["spec"] for lf in leaves}

    def split(key, dim) -> bool:
        e = specs[key][dim - 2]
        return e is not None and "model" in (e if isinstance(e, tuple)
                                              else (e,))
    return split


def norm_bytes(leaves, grid) -> int:
    """The global norm's float32 sums: one per set of axes of more than
    one process that splits some leaf (``optim/adamw.py::global_norm``)."""
    sets = set()
    for lf in leaves:
        axes = frozenset(a for e in lf["spec"] if e is not None
                         for a in (e if isinstance(e, tuple) else (e,))
                         if grid.shape[grid.axis_index(a)] > 1)
        if axes:
            sets.add(axes)
    return 4 * len(sets)


def whole_bytes(weights, M: int, passes: int) -> tuple:
    """(all-gather, reduce-scatter, all-reduce) operand bytes, a
    microbatch, of ``weights`` used whole on every model rank
    (``tp.whole_over_model``), each given as (its bytes, whether "model"
    splits it): a split one is gathered in each of ``passes`` (the
    forward and the recompute) and its whole gradient reduce-scattered
    once; a replicated one passes ``copy_to_model``, whose backward
    all-reduces its gradient once."""
    ag = rs = ar = 0
    for n, is_split in weights:
        if is_split:
            ag += passes * n // M
            rs += n
        else:
            ar += n
    return ag, rs, ar


def attn_whole(cfg, M: int, split, mod: str) -> list:
    """The weights of one attention (``mod``: its module name) taken whole
    over "model", as :func:`whole_bytes` takes them: ``wq`` and ``wo``
    when M does not divide the H query heads
    (``transformer.local_q_o``), ``wk`` and ``wv`` when it does not
    divide the Kh KV heads (``local_kv``)."""
    a = 2 if cfg.dtype == "bfloat16" else 4
    H, Kh, D, hd = cfg.n_heads, cfg.n_kv, cfg.d_model, cfg.head_dim
    names = ([("wq", 1, H), ("wo", 0, H)] if H % M else []) + \
        ([("wk", 1, Kh), ("wv", 1, Kh)] if Kh % M else [])
    return [(n * hd * D * a, split((mod, name), dim))
            for name, dim, n in names]


def ep_counted_bytes(cfg, leaves, grid, *, tokens: int,
                     microbatches: int) -> dict:
    """The operand bytes per step and rank that the placed MoE step counts
    (``core/grid.py::COLLECTIVE_BYTES``; PERF.md §5's arithmetic): the
    layers' FSDP gathers in the forward and, under remat, the recompute,
    the top-level ones once a microbatch; the reduce-scatters once a
    microbatch; the flat all-reduce of the unsplit leaves and the loss;
    the global norm's sum per set of splitting axes (:func:`norm_bytes`);
    per layer and
    microbatch the attention's two reduces (``wo``'s, recomputed under
    remat, and ``copy_to_model``'s backward) and the expert-parallel
    MoE's three (its combine, which torch's recompute stops before, and
    the backward of its input and of its float32 router); the attention
    weights taken whole where M does not divide the heads
    (:func:`attn_whole`); where M does not divide the experts and the
    batch axes hold several processes, the one global group's per-expert
    counts (int64, ``moe.expert_counts``) gathered over them in each
    pass of each layer; the vocab-parallel embedding, head and
    loss terms where "model" splits the vocabulary (the loss's three in
    its forward and in its chunk's recompute, with or without remat).
    T = ``tokens`` a rank and microbatch."""
    from repro_torch.launch.dryrun import fsdp_all_gather, \
        grad_all_reduce, grad_reduce_scatter
    mb, T, D, a = microbatches, tokens, cfg.d_model, \
        2 if cfg.dtype == "bfloat16" else 4
    M = grid.shape[grid.axis_index("model")]
    remat = cfg.remat != "none"
    layers = [lf for lf in leaves if lf["path"][0] == "layers"]
    top = [lf for lf in leaves if lf["path"][0] != "layers"]
    gather = fsdp_all_gather(layers, grid, passes=1 + remat,
                             microbatches=mb) + \
        fsdp_all_gather(top, grid, passes=1, microbatches=mb)
    reduce = grad_all_reduce(leaves, grid, batch_split=batch_ranks(grid)
                             > 1) + norm_bytes(leaves, grid)
    scatter = grad_reduce_scatter(leaves, grid, microbatches=mb)
    if batch_ranks(grid) > 1 and cfg.n_experts % M:
        gather += mb * cfg.n_layers * (1 + remat) * cfg.n_experts * 8
    if M > 1:
        per_layer = (2 + remat) * T * D * a
        if cfg.n_experts % M == 0:
            per_layer += 2 * T * D * a + D * cfg.n_experts * 4
        ag, rs, ar = whole_bytes(attn_whole(
            cfg, M, model_split_of(leaves), "layers"), M, 1 + remat)
        gather += mb * cfg.n_layers * ag
        scatter += mb * cfg.n_layers * rs
        reduce += mb * cfg.n_layers * (per_layer + ar)
        if cfg.vocab % M == 0:
            reduce += mb * (2 * T * D * a + 2 * 3 * T * 4)
    return {"all-gather": gather, "reduce-scatter": scatter,
            "all-reduce": reduce, "all-to-all": 0}


class RouteTape:
    """Records, or replays, the experts that ``models/moe.py::_top_k``
    picks, call by call: the float32 comparison of the ep_train phase
    routes the placed run as one process routed, so that a token whose
    K-th and (K+1)-th logits lie within float32 rounding of each other
    (the two runs sum the hidden state in different orders) cannot send
    one run down another path.  Replaying, it counts the (token, call)
    rows whose own choice differs from the tape's and keeps their own
    gaps between the K-th and (K+1)-th logits.  ``rows`` picks this
    rank's groups of each recorded call."""

    def __init__(self, torch, replay=None, rows=None):
        self.torch, self.replay, self.rows = torch, replay, rows
        self.calls, self.flips, self.flip_gaps = [], 0, []

    def __enter__(self):
        from repro_torch.models import moe
        self.mod, self.real = moe, moe._top_k
        moe._top_k = self.top_k
        return self

    def __exit__(self, *exc):
        self.mod._top_k = self.real

    def top_k(self, logits, K):
        torch = self.torch
        vals, idx = self.real(logits, K + 1)
        gap = vals[..., K - 1] - vals[..., K]
        vals, idx = vals[..., :K], idx[..., :K]
        if self.replay is None:
            self.calls.append(idx.to(torch.int16).cpu())
            return vals, idx
        want = self.replay[len(self.calls)][self.rows].to(idx.device,
                                                         torch.long)
        self.calls.append(None)
        differ = (idx.sort(-1)[0] != want.sort(-1)[0]).any(-1)
        self.flips += int(differ.sum())
        self.flip_gaps += gap[differ].tolist()
        return torch.gather(logits, -1, want), want


def ep_train_rank(rank, job):
    """One rank of the ep_train phase (a spawned process of
    ``run_ranks``): the placed Trainer (no checkpoint), then the float32
    depth-cut run.  It measures and compares; the parent makes
    every check."""
    import dataclasses
    import torch

    from repro_torch.core.grid import ProcGrid
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import sphere_pack
    from repro_torch.kernels.dft_matmul import dft_matmul, \
        dft_matmul_twiddle
    from repro_torch.models.model_zoo import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import ctx, rules
    from repro_torch.train.trainer import Trainer, TrainerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(job["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    wrappers = (dft_matmul, dft_matmul_twiddle, sphere_pack.unpack_dft,
                sphere_pack.dft_pack)
    for fn in wrappers:
        fn.launches = 0
    grid = ProcGrid.create(EP_GRID, EP_AXES, device=dev)
    cfg = shard_config(job["reduced"], TRAIN_MOE, EP_LAYERS)
    dcfg = DataConfig(vocab=cfg.vocab, seq=job["seq"],
                      global_batch=job["batch"])
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                       total_steps=TRAIN_RESUME_STEPS)
    out = {"coordinate": grid.coordinate}
    with ctx.use(grid, ("data",)):
        bundle = build(cfg, device=dev)
        tr = fixed_batch_trainer(Trainer(bundle, ocfg, TrainerConfig(
            total_steps=EP_STEPS, ckpt_every=1000, log_every=1000,
            microbatches=TRAIN_MB, ckpt_dir=job["ckpt"]), dcfg, grid=grid))
        tr._save = lambda *args, **kw: None      # no checkpoint
        rec, params, opt = placed_trainer_run(torch, dev, tr)
        out.update(rec)
        pl = rules.placement_of(params)
        out["expert_block"] = (tuple(params.layers[0].moe.w_up.shape),
                               pl.shapes["layers.0.moe.w_up"])
        del params, opt, tr, pl
        if cuda:
            torch.cuda.empty_cache()

        # float32 at published width, EP_EXACT_LAYERS layers, routed as
        # one process routed (this rank's rows of each recorded call)
        shard = grid.coordinate[grid.axis_index("data")]
        n = job["batch"] // EP_GRID[0] // TRAIN_MB      # rows a group call
        tape = RouteTape(torch, torch.load(job["routes"]),
                         slice(shard * n, (shard + 1) * n))
        out["exact"] = placed_exact_run(
            torch, grid, dataclasses.replace(
                cfg, dtype="float32", n_layers=EP_EXACT_LAYERS), dcfg,
            job, rank, EP_EXACT_STEPS, tape)
        out["exact"].update(route_flips=tape.flips,
                            flip_gaps=tape.flip_gaps)
    out["launches"] = {fn.__name__: fn.launches for fn in wrappers}
    return out


def run_ep_train(torch, dev, gpu, wrappers) -> dict:
    """The ep_train phase (see EP_*): one process's references in this
    process, routed as on EP_GRID and freed before the ranks start, then
    EP_PROCS ranks, with every kernel wrapper's count set to 0 just before
    and read just after (the path reaches no hand kernel).  No checkpoint
    is written (the whole model's would be 3.30 B parameters × 10 B, ~33
    GB): the sharded_train and tp_train phases restore theirs into blocks
    on the card, and
    the CPU tests (``tests/test_torch_ep_train.py``) restore expert
    blocks bitwise."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.core.grid import ProcGrid
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch.dryrun import model_collectives, param_leaves, \
        state_bytes
    from repro_torch.models.model_zoo import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import ctx
    from repro_torch.sharding.procs import run_ranks
    t0 = time.perf_counter()
    print(f"expert-parallel train path ({SHARD_TAG}; experts over "
          f"\"model\", FSDP over \"data\"): grid {EP_GRID} {EP_AXES}; card "
          f"{gpu}", flush=True)
    for fn in wrappers.values():
        fn.launches = 0
    cfg = shard_config(EP_REDUCED, TRAIN_MOE, EP_LAYERS)
    dcfg = DataConfig(vocab=cfg.vocab, seq=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in Pipeline(dcfg).batch_at(0).items()}
    # one process, routed per batch row as on the grid: the first
    # full-width step (a whole 3.30 B model, its accumulator and moments,
    # freed before the ranks start), the float32 depth-cut run
    torch.cuda.empty_cache()
    # a one-point grid of EP_AXES installed: the MoE routes per batch row,
    # as on EP_GRID (the reference's groups where "model" divides E)
    with ctx.use(ProcGrid.create((1,) * len(EP_AXES), EP_AXES, device=dev),
                 None):
        lw, nw, model, _ = _one_process_step(
            torch, dev, cfg, AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                         total_steps=TRAIN_RESUME_STEPS),
            batch, 1)
        del model
        torch.cuda.empty_cache()
        c32 = dataclasses.replace(cfg, dtype="float32",
                                  n_layers=EP_EXACT_LAYERS)
        with RouteTape(torch) as tape:
            l32, n32, model, m32 = _one_process_step(
                torch, dev, c32, AdamWConfig(
                    lr=TRAIN_AGREE_LR, warmup_steps=1,
                    total_steps=TRAIN_STEPS), batch, EP_EXACT_STEPS)
    os.makedirs(EP_DIR, exist_ok=True)
    exact_path = os.path.join(EP_DIR, "exact_params.pt")
    routes_path = os.path.join(EP_DIR, "routes.pt")
    torch.save({"params": {n: p.detach().cpu()
                           for n, p in model.named_parameters()},
                "m1": m32}, exact_path)
    torch.save(tape.calls, routes_path)
    del model, batch, m32, tape
    torch.cuda.empty_cache()
    ckpt = tempfile.mkdtemp(prefix="ep_ckpt_", dir=EP_DIR)
    job = {"device": str(dev), "ckpt": ckpt, "exact_params": exact_path,
           "routes": routes_path, "reduced": EP_REDUCED, "seq": TRAIN_SEQ,
           "batch": TRAIN_BATCH}
    t1 = time.perf_counter()
    try:
        ranks = run_ranks(ep_train_rank, EP_PROCS, args=(job,),
                          rendezvous_dir=EP_DIR, timeout=EP_TIMEOUT,
                          threads=SHARD_THREADS, nice=19)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        os.remove(exact_path)
        os.remove(routes_path)
    ranks_s = time.perf_counter() - t1

    agrid = ProcGrid.create_abstract(EP_GRID, EP_AXES)
    leaves = param_leaves(build(cfg, device="meta").init(None), agrid)
    acct = state_bytes(leaves, agrid, kind="train", microbatches=TRAIN_MB)
    rows = TRAIN_BATCH // EP_GRID[0]
    model_coll = model_collectives(
        cfg, "train", leaves, agrid, batch=rows, seq=TRAIN_SEQ,
        microbatches=TRAIN_MB, batch_split=True)
    arith = ep_counted_bytes(cfg, leaves, agrid,
                             tokens=rows // TRAIN_MB * TRAIN_SEQ,
                             microbatches=TRAIN_MB)
    out = {"one_process": {"loss": lw[0], "grad_norm": nw[0],
                           "exact_losses": l32, "exact_norms": n32},
           "accounting": acct, "model_collectives": model_coll,
           "arithmetic": arith, "ranks_s": ranks_s, "ranks": ranks}
    El = cfg.n_experts // EP_GRID[1]
    for r, o in enumerate(ranks):
        h = o["history"]
        dts = [x["dt"] for x in h]
        steady = sum(dts[1:]) / len(dts[1:])
        o["steady_step_ms"] = steady * 1e3
        print(f"  rank {r} {o['coordinate']}: parameters "
              f"{o['param_bytes']:,} B, AdamW state {o['opt_bytes']:,} B "
              f"(accounting {acct['params']:,} and {acct['opt_state']:,});"
              f" expert block {o['expert_block'][0]} of "
              f"{o['expert_block'][1]}; peak "
              f"{_gib(o['peak_bytes'] / 2**30)}; step ms "
              + ", ".join(f"{d * 1e3:.1f}" for d in dts)
              + f", steady {steady * 1e3:.1f} ({SHARD_TAG}, {gpu}); "
              f"losses " + ", ".join(f"{x['loss']:.5f}" for x in h),
              flush=True)
        check(o["placed"] and o["on_card"] and
              o["expert_block"][0][0] == El,
              f"rank {r}: weights placed, {El} experts a model rank, every "
              f"tensor on {dev}")
        check(o["param_bytes"] == acct["params"] and
              o["opt_bytes"] == acct["opt_state"],
              f"rank {r}: parameter and AdamW state bytes equal the dry "
              f"run's state_bytes on the abstract {EP_GRID} grid to the "
              "byte")
        check(all(c == arith for c in o["collectives_per_step"]),
              f"rank {r}: the counted collective bytes of every step equal "
              f"the arithmetic {arith} (counted "
              f"{o['collectives_per_step']})")
        check(o["history"][0]["loss"] == ranks[0]["history"][0]["loss"],
              f"rank {r}: the same loss as rank 0")
    counted = ranks[0]["collectives_per_step"][0]
    print("  collective operand bytes per step and device (counted on rank "
          "0, step 1) vs the dry run's model_collectives (its all-to-all: "
          "the sequence-parallel routed tokens): " + ", ".join(
              f"{k} {counted.get(k, 0):,} vs {model_coll[k]:,} "
              f"({counted.get(k, 0) - model_coll[k]:+,})"
              for k in model_coll), flush=True)
    first = ranks[0]["history"][0]
    dl = abs(first["loss"] - lw[0]) / abs(lw[0])
    dg = abs(first["grad_norm"] - nw[0]) / abs(nw[0])
    out["full_width_agreement"] = {"loss_rel": dl, "grad_norm_rel": dg}
    check(dl <= EP_LOSS_RTOL and dg <= EP_GNORM_RTOL,
          f"{TRAIN_MOE} bf16 placed vs one process routed per row, first "
          f"step: loss {first['loss']:.6f} vs {lw[0]:.6f} ({dl:.2e} <= "
          f"{EP_LOSS_RTOL:g}), grad_norm {first['grad_norm']:.6f} vs "
          f"{nw[0]:.6f} ({dg:.2e} <= {EP_GNORM_RTOL:g})")
    ex = ranks[0]["exact"]
    el = max(abs(a - b) / abs(b) for a, b in zip(ex["losses"], l32))
    en = max(abs(a - b) / abs(b) for a, b in zip(ex["norms"], n32))
    # the routing census: each data rank's rows once (model rank 0)
    lead = [o["exact"] for o in ranks if o["coordinate"][1] == 0]
    flips = sum(e["route_flips"] for e in lead)
    gaps = [abs(g) for e in lead for g in e["flip_gaps"]]
    out["exact_agreement"] = {"loss_rel": el, "grad_norm_rel": en,
                              "param_err": ex["param_err"],
                              "first_moment_err": ex["first_moment_err"],
                              "route_flips": flips,
                              "flip_gap_max": max(gaps, default=0.0)}
    check(all(g <= EP_TIE for g in gaps),
          f"{TRAIN_MOE} float32: {flips} (token, call) rows of the "
          f"{EP_EXACT_STEPS} steps route otherwise on the grid than in one "
          "process (replayed as one process routed), each at a near tie: "
          f"the K-th and (K+1)-th logits within {max(gaps, default=0.0):.2e}"
          f" <= {EP_TIE:g}")
    check(el <= SHARD_EXACT_RTOL and en <= SHARD_EXACT_RTOL and
          ex["first_moment_err"][0] <= SHARD_EXACT_RTOL and
          ex["param_err"][0] <= SHARD_EXACT_PARAM,
          f"{TRAIN_MOE} float32, {EP_EXACT_LAYERS} layers, "
          f"{EP_EXACT_STEPS} steps, placed vs one process: loss "
          f"{el:.2e}, grad_norm {en:.2e}, the first step's gradient "
          f"(first moment) {ex['first_moment_err'][0]:.2e} of its largest "
          f"(at {ex['first_moment_err'][1]}) <= {SHARD_EXACT_RTOL:g}; "
          f"parameters {ex['param_err'][0]:.2e} of the largest (at "
          f"{ex['param_err'][1]}) <= {SHARD_EXACT_PARAM:g}")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    for o in ranks:
        for k, v in o["launches"].items():
            launches[k] += v
    out["launches"] = launches
    check(not any(launches.values()),
          f"the expert-parallel train path launched no hand kernel: "
          f"{launches}")
    out["seconds"] = time.perf_counter() - t0
    print(f"ep_train phase: {out['seconds']:.1f} s (ranks "
          f"{ranks_s:.1f} s)", flush=True)
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------- the tensor-parallel path
def tp_config(arch: str, reduced: bool, cut: dict):
    """``arch``'s config for the tp_train phase: :func:`shard_config`
    with ``cut`` applied (a rehearsal's reduced config stays as it
    is)."""
    import dataclasses
    cfg = shard_config(reduced, arch)
    return cfg if reduced else dataclasses.replace(cfg, **cut)


def tp_extra(torch, cfg, dev) -> dict:
    """The batch's stub frontend input beside its tokens: an
    encoder-decoder's frames (TRAIN_BATCH, enc_seq, d_model), drawn from
    SEED on ``dev`` (the same on every process)."""
    if cfg.family != "encdec":
        return {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return {"frames": torch.randn((TRAIN_BATCH, cfg.enc_seq, cfg.d_model),
                                  generator=gen, device=dev)}


def _stacked_leaf(leaf) -> bool:
    return leaf["path"][0] in ("layers", "groups", "tail", "enc_layers",
                               "dec_layers", "cross")


def tp_counted_bytes(cfg, leaves, grid, *, tokens: int, enc_tokens: int,
                     microbatches: int) -> dict:
    """The operand bytes per step and rank that the placed step of the
    SSM, hybrid or encoder-decoder family counts
    (``core/grid.py::COLLECTIVE_BYTES``; PERF.md §5's arithmetic): the
    layers' FSDP gathers in the forward and, under remat, the recompute,
    the top-level ones once a microbatch, the reduce-scatters once; the
    flat all-reduce of the leaves the batch axes do not split and the
    loss, where the batch axes hold several processes; the global norm's
    sum per set of splitting axes (:func:`norm_bytes`).  Over "model", a
    microbatch: each column-parallel input's backward all-reduce
    (``copy_to_model``) once;
    each row-parallel sum (``reduce_from_model``) in the forward and in
    the recompute, but for the last of a layer body, which torch's
    recompute stops before; the weights taken whole over "model" inside
    the layer bodies (Mamba-2's ``in_proj`` and ``conv_w``, and its
    ``out_proj`` when M does not divide the SSD heads; the attention
    weights whose heads M does not divide, :func:`attn_whole`) and the
    RG-LRU's u, gathered in both passes and reduce-scattered once;
    Mamba-2's norm statistic (``sum_over_model``) in both passes and once
    in the backward, and the replicated float32 vectors each rank uses a
    slice of (``copy_to_model``) once; the encoder states'
    ``copy_to_model`` once; the vocab-parallel embedding, head and loss
    terms where "model" splits them.  T (Te) = a rank's decoder (encoder)
    ``tokens`` a
    microbatch."""
    from repro_torch.launch.dryrun import fsdp_all_gather, \
        grad_all_reduce, grad_reduce_scatter
    mb, T, Te, D = microbatches, tokens, enc_tokens, cfg.d_model
    a = 2 if cfg.dtype == "bfloat16" else 4
    M = grid.shape[grid.axis_index("model")]
    P = 1 + (cfg.remat != "none")              # a layer body's passes
    layers = [lf for lf in leaves if _stacked_leaf(lf)]
    top = [lf for lf in leaves if not _stacked_leaf(lf)]
    gather = fsdp_all_gather(layers, grid, passes=P, microbatches=mb) + \
        fsdp_all_gather(top, grid, passes=1, microbatches=mb)
    reduce = grad_all_reduce(leaves, grid, batch_split=batch_ranks(grid)
                             > 1) + norm_bytes(leaves, grid)
    scatter = grad_reduce_scatter(leaves, grid, microbatches=mb)
    if M == 1:
        return {"all-gather": gather, "reduce-scatter": scatter,
                "all-reduce": reduce, "all-to-all": 0}
    K = cfg.conv_kernel
    split = model_split_of(leaves)
    ag = rs = ar = 0

    def whole(*weights):
        """Weights used whole on every model rank (:func:`whole_bytes`)."""
        nonlocal ag, rs, ar
        g, r, c = whole_bytes(weights, M, P)
        ag, rs, ar = ag + g, rs + r, ar + c

    def attn(t, last, mod):
        """A self- or cross-attention on t tokens: the input's backward,
        wo's sum (recomputed unless ``last``), the weights taken whole
        where M does not divide the heads (:func:`attn_whole`)."""
        nonlocal ar
        ar += t * D * a + (1 if last else P) * t * D * a
        whole(*attn_whole(cfg, M, split, mod))

    def mlp(t, last):
        nonlocal ar
        ar += t * D * a + (1 if last else P) * t * D * a

    def rec(t, last_mlp):
        nonlocal ag, rs, ar
        R = cfg.d_rnn or D
        ag += P * t * R // M * a              # u, for the gates
        rs += t * R * a
        ar += t * D * a + P * t * D * a + R * 4
        mlp(t, last_mlp)

    if cfg.family == "ssm":
        din, N, Hs = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
        for _ in range(cfg.n_layers):
            whole((D * (2 * din + 2 * N + Hs) * a,
                   split(("ssm", "in_proj"), 1)),
                  (K * (din + 2 * N) * a, split(("ssm", "conv_w"), 1)))
            if Hs % M:                        # out_proj's rows off heads
                whole((din * D * a, split(("ssm", "out_proj"), 0)))
            ar += 2 * T * D * a + (P + 1) * T * 4 + (3 * Hs + din) * 4
    elif cfg.family == "hybrid":
        n_groups = cfg.n_layers // len(cfg.block_pattern)
        for _ in range(n_groups):
            rec(T, False)
            rec(T, False)
            attn(T, False, "attn")
            mlp(T, True)
        for _ in range(cfg.n_layers - n_groups * len(cfg.block_pattern)):
            rec(T, True)
    else:                                     # encdec
        for _ in range(cfg.enc_layers):
            attn(Te, False, "enc_layers")
            mlp(Te, True)
        for _ in range(cfg.n_layers):
            attn(T, False, "dec_layers")
            attn(T, False, "cross")
            mlp(T, True)
        ar += Te * D * a                      # the encoder states' copy
    head = ("lm_head",) if any(lf["path"] == ("lm_head",)
                               for lf in leaves) else ("embed",)
    if split(("embed",), 0):
        ar += T * D * a                       # the embedding's sum
    if split(head, 1 if head == ("lm_head",) else 0):
        ar += T * D * a + 2 * 3 * T * 4       # head input; loss terms
    return {"all-gather": gather + mb * ag,
            "reduce-scatter": scatter + mb * rs,
            "all-reduce": reduce + mb * ar, "all-to-all": 0}


def tp_phase(name: str) -> dict:
    """The settings of a tensor-parallel phase, read from its constants
    when called (a rehearsal may have changed them; a rank finds its
    phase by the job's ``phase``): ``tp_train`` (TP_*) or ``tp_uneven``
    (UNEVEN_*) or ``tp_production`` (PRODUCTION_*, else UNEVEN_*), one
    process a point of its ``grid``.  ``mb``: each model's microbatches
    where not TRAIN_MB."""
    if name == "tp_train":
        return {"name": name, "grid": TP_GRID, "mb": {}, "axes": TP_AXES,
                "models": TP_MODELS, "ckpt": TP_CKPT,
                "bf16_rtol": TP_BF16_RTOL,
                "exact_rtol": SHARD_EXACT_RTOL, "timeout": TP_TIMEOUT,
                "dir": TP_DIR, "reduced": TP_REDUCED,
                "title": "tensor-parallel train path", "what":
                "the SSM, RG-LRU and encoder-decoder families' heads and "
                "channels over \"model\", FSDP over \"data\""}
    if name == "tp_uneven":
        return {"name": name, "grid": UNEVEN_GRID, "mb": {},
                "axes": UNEVEN_AXES, "models": UNEVEN_MODELS, "ckpt": None,
                "bf16_rtol": UNEVEN_BF16_RTOL,
                "exact_rtol": UNEVEN_EXACT_RTOL, "timeout": UNEVEN_TIMEOUT,
                "dir": UNEVEN_DIR, "reduced": UNEVEN_REDUCED,
                "title": "tensor-parallel train path, heads split unevenly",
                "what": "each model rank's tp.head_range of the heads, "
                "the attention weights whole over \"model\""}
    if name == "tp_production":
        return {**tp_phase("tp_uneven"), "name": name,
                "grid": PRODUCTION_GRID, "mb": PRODUCTION_MB,
                "models": PRODUCTION_MODELS,
                "bf16_rtol": PRODUCTION_BF16_RTOL, "dir": PRODUCTION_DIR,
                "title": "tensor-parallel train path on the reference's "
                "16-way \"model\" axis"}
    raise ValueError(name)


def kv_heads_of(torch, p, cfg, dev) -> list:
    """(query head, the KV head whose keys it reads) for each of this model
    rank's heads: ``transformer.local_kv``'s keys of a probe input, each
    matched against the KV heads of the whole ``wk`` (gathered over
    "model"; every model rank takes part)."""
    from repro_torch.models import transformer
    from repro_torch.sharding import tp
    h0, Hl = transformer.local_heads(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((1, 4, cfg.d_model), generator=gen, device=dev).to(
        p.wk.dtype)
    with torch.no_grad():
        k, _ = transformer.local_kv(p, x, cfg, h0, Hl)
        whole = (x @ tp.whole_over_model(p, "wk", 1)).reshape(
            1, 4, cfg.n_kv, cfg.head_dim)
    return [(h0 + j, next((i for i in range(cfg.n_kv)
                           if torch.equal(k[:, :, j], whole[:, :, i])), None))
            for j in range(Hl)]


class watch_dispatch:
    """Records the (groups, tokens a group, whether the group's rows span
    several ranks, whether the experts are split) of every MoE dispatch
    (``models/moe.py::_dispatch``) while it is entered."""

    def __enter__(self):
        from repro_torch.models import moe
        self.mod, self.real, self.seen = moe, moe._dispatch, set()

        def spy(xg, *args, **kw):
            self.seen.add((xg.shape[0], xg.shape[1],
                           kw.get("peers") is not None, bool(kw.get("ep"))))
            return self.real(xg, *args, **kw)
        moe._dispatch = spy
        return self

    def __exit__(self, *exc):
        self.mod._dispatch = self.real


#: the spawned ranks' allocator: up to 16 processes share the card, and
#: each caching allocator's unused blocks would be lost to the others
#: (Granite-MoE on (1, 16) reserved 3.85-4.14 GiB a rank for a peak of
#: 3.41 GiB allocated, ~10 GiB over 16 ranks, and in the whole script,
#: whose own process holds more of the card by then, ran out of it);
#: expandable segments keep each rank's reservation near its peak
TP_ALLOC_CONF = "expandable_segments:True"


class alloc_conf:
    """``PYTORCH_CUDA_ALLOC_CONF`` set to ``value`` for the processes
    spawned while it is entered (this process's allocator has already
    read it)."""

    def __init__(self, value: str):
        self.value = value

    def __enter__(self):
        self.old = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = self.old


def tp_model_rank(torch, grid, arch: str, job: dict, rank: int) -> dict:
    """One model of a tensor-parallel phase on this rank: the placed
    Trainer (the phase's ``ckpt`` model's final checkpoint restored into
    blocks), then the float32 cut run (an MoE's replaying one process's
    routing).  It measures and compares; the parent makes every
    check."""
    import contextlib
    import dataclasses

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model_zoo import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import ctx, rules, tp
    from repro_torch.train.trainer import Trainer, TrainerConfig
    phase = tp_phase(job["phase"])
    dev = grid.device
    cut, cut32 = phase["models"][arch]
    mb = phase["mb"].get(arch, TRAIN_MB)
    cfg = tp_config(arch, job["reduced"], cut)
    moe = cfg.family == "moe"
    extra = tp_extra(torch, cfg, dev)
    dcfg = DataConfig(vocab=cfg.vocab, seq=job["seq"],
                      global_batch=job["batch"])
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                       total_steps=TRAIN_RESUME_STEPS)
    ckpt = os.path.join(job["ckpt"], arch)
    out = {}
    with ctx.use(grid, ("data",)):
        bundle = build(cfg, device=dev)
        out["heads"] = tp.head_range(cfg.n_heads) if cfg.n_heads else None

        def trainer():
            return fixed_batch_trainer(Trainer(bundle, ocfg, TrainerConfig(
                total_steps=TP_STEPS, ckpt_every=1000, ckpt_keep=1,
                log_every=1000, microbatches=mb, ckpt_dir=ckpt),
                dcfg, grid=grid, extra_batch=extra))
        tr = trainer()
        if arch != phase["ckpt"]:
            tr._save = lambda *args, **kw: None
        with watch_dispatch() if moe else contextlib.nullcontext() as seen:
            rec, params, opt = placed_trainer_run(torch, dev, tr)
        out.update(rec)
        out["model_split"] = sorted(
            n for n, sp in rules.placement_of(params).specs.items()
            if any("model" in ax for ax in sp))
        if moe:
            out["experts"] = params.layers[0].moe.w_up.shape[0]
            out["moe_dispatch"] = sorted(seen.seen)
            if cfg.n_kv % tp.model_size():        # wk/wv taken whole
                out["kv_heads"] = kv_heads_of(torch, params.layers[0], cfg,
                                              dev)
        mine = host_state(params, opt) if arch == phase["ckpt"] else None
        del params, opt, tr
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if mine is not None:
            out.update(restore_into_blocks(torch, dev, trainer, *mine))
            del mine
        c32 = dataclasses.replace(tp_config(arch, job["reduced"], cut32),
                                  dtype="float32")
        d32 = dataclasses.replace(dcfg, vocab=c32.vocab)
        # an MoE routes as one process routed (every model rank the same
        # rows: "data" holds one process, or the model ranks of a data
        # rank alike)
        tape = RouteTape(torch, torch.load(job["routes"][arch]),
                         slice(None)) if moe else None
        out["exact"] = placed_exact_run(
            torch, grid, c32, d32, {**job, "exact_params":
                                    job["exact_params"][arch]},
            rank, TP_EXACT_STEPS, tape, extra=tp_extra(torch, c32, dev),
            microbatches=mb)
        if tape is not None:
            out["exact"].update(route_flips=tape.flips,
                                flip_gaps=tape.flip_gaps)
    return out


def tp_train_rank(rank, job):
    """One rank of a tensor-parallel phase (a spawned process of
    ``run_ranks``): every model of the phase in turn."""
    import torch

    from repro_torch.core.grid import ProcGrid
    from repro_torch.kernels import sphere_pack
    from repro_torch.kernels.dft_matmul import dft_matmul, \
        dft_matmul_twiddle
    torch.backends.cuda.matmul.allow_tf32 = False
    phase = tp_phase(job["phase"])
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    wrappers = (dft_matmul, dft_matmul_twiddle, sphere_pack.unpack_dft,
                sphere_pack.dft_pack)
    for fn in wrappers:
        fn.launches = 0
    grid = ProcGrid.create(phase["grid"], phase["axes"], device=dev)
    out = {"coordinate": grid.coordinate, "models": {}}
    for arch in phase["models"]:
        t0 = time.perf_counter()
        out["models"][arch] = tp_model_rank(torch, grid, arch, job, rank)
        out["models"][arch]["seconds"] = time.perf_counter() - t0
    out["launches"] = {fn.__name__: fn.launches for fn in wrappers}
    return out


def drop_tp_references(refs: dict) -> None:
    """Delete the files of :func:`tp_references`' records ``refs``."""
    for ref in refs.values():
        for key in ("path", "routes"):
            if key in ref:
                os.remove(ref[key])
    refs.clear()


def tp_references(torch, dev, arch: str, phase: dict, refs: dict) -> dict:
    """One process's runs of ``arch`` for a tensor-parallel phase, in this
    process, or an earlier phase's of the same configs from ``refs`` (by
    arch, bf16 config, float32 config and microbatches: Whisper-small
    trains alike in tp_train and tp_uneven): the first bf16 step's loss
    and grad_norm, and the float32 cut run (its parameters and first
    moment saved under the phase's directory; an MoE's routing too, for
    the ranks to replay).  An MoE routes in one group, as on a grid whose
    "model" axis does not divide its experts and whose "data" axis holds
    one process."""
    import contextlib
    import dataclasses

    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.optim.adamw import AdamWConfig
    cut, cut32 = phase["models"][arch]
    mb = phase["mb"].get(arch, TRAIN_MB)
    cfg = tp_config(arch, phase["reduced"], cut)
    c32 = dataclasses.replace(tp_config(arch, phase["reduced"], cut32),
                              dtype="float32")
    key = (arch, cfg, c32, mb)
    if key in refs:
        return refs[key]
    dcfg = DataConfig(vocab=cfg.vocab, seq=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in Pipeline(dcfg).batch_at(0).items()}
    torch.cuda.empty_cache()
    lw, nw, model, _ = _one_process_step(
        torch, dev, cfg, AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                     total_steps=TRAIN_RESUME_STEPS),
        {**batch, **tp_extra(torch, cfg, dev)}, 1, mb)
    del model
    torch.cuda.empty_cache()
    d32 = dataclasses.replace(dcfg, vocab=c32.vocab)
    b32 = {k: torch.from_numpy(v).to(dev)
           for k, v in Pipeline(d32).batch_at(0).items()}
    moe = c32.family == "moe"
    with RouteTape(torch) if moe else contextlib.nullcontext() as tape:
        l32, n32, model, m32 = _one_process_step(
            torch, dev, c32, AdamWConfig(lr=TRAIN_AGREE_LR, warmup_steps=1,
                                         total_steps=TRAIN_STEPS),
            {**b32, **tp_extra(torch, c32, dev)}, TP_EXACT_STEPS, mb)
    path = os.path.join(phase["dir"], f"exact_{arch}.pt")
    torch.save({"params": {n: p.detach().cpu()
                           for n, p in model.named_parameters()},
                "m1": m32}, path)
    out = {"cfg": cfg, "loss": lw[0], "grad_norm": nw[0],
           "exact_losses": l32, "exact_norms": n32, "path": path,
           "phase": phase["name"]}
    if moe:
        out["routes"] = os.path.join(phase["dir"], f"routes_{arch}.pt")
        torch.save(tape.calls, out["routes"])
    del model, m32, tape
    torch.cuda.empty_cache()
    refs[key] = out
    return out


def run_tp_train(torch, dev, gpu, wrappers, name: str = "tp_train",
                 references: dict | None = None) -> dict:
    """A tensor-parallel phase (:func:`tp_phase`; see TP_* and UNEVEN_*):
    one process's references of every model in this process, freed
    before the ranks start, then the phase's ranks running every model,
    with every kernel wrapper's count set to 0 just before and read just
    after (the path reaches no hand kernel).  ``references``:
    :func:`tp_references`' records that the caller keeps across phases
    and drops; else the phase's own."""
    import shutil
    import tempfile

    from repro_torch.core.grid import ProcGrid
    from repro_torch.launch.dryrun import model_collectives, param_leaves, \
        state_bytes
    from repro_torch.models.model_zoo import build
    from repro_torch.sharding.procs import run_ranks
    phase = tp_phase(name)
    grid_shape, axes = phase["grid"], phase["axes"]
    procs, M = math.prod(grid_shape), grid_shape[axes.index("model")]
    tag = f"{procs} processes on one card, gloo"
    t0 = time.perf_counter()
    print(f"{phase['title']} ({tag}; {phase['what']}): grid {grid_shape} "
          f"{axes}; card {gpu}", flush=True)
    for fn in wrappers.values():
        fn.launches = 0
    os.makedirs(phase["dir"], exist_ok=True)
    kept = {} if references is None else references
    refs = {}
    for arch in phase["models"]:
        t1 = time.perf_counter()
        refs[arch] = tp_references(torch, dev, arch, phase, kept)
        print(f"  {arch}: one process's references "
              + (f"{time.perf_counter() - t1:.1f} s"
                 if refs[arch]["phase"] == name else
                 f"of the {refs[arch]['phase']} phase (the same configs)"),
              flush=True)
    if phase["ckpt"] is not None:
        need = ckpt_gib(refs[phase["ckpt"]]["cfg"])
        free = shutil.disk_usage(phase["dir"]).free / 2**30
        check(free >= 1.05 * need,
              f"{free:.1f} GiB of free disk for {phase['ckpt']}'s "
              f"{need:.2f} GiB checkpoint with 5% to spare")
    ckpt = tempfile.mkdtemp(prefix="tp_ckpt_", dir=phase["dir"])
    job = {"phase": name, "device": str(dev), "ckpt": ckpt,
           "reduced": phase["reduced"], "seq": TRAIN_SEQ,
           "batch": TRAIN_BATCH,
           "exact_params": {a: r["path"] for a, r in refs.items()},
           "routes": {a: r["routes"] for a, r in refs.items()
                      if "routes" in r}}
    if dev.type == "cuda":
        torch.backends.cuda.cufft_plan_cache.clear()
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info(dev)[0] / 2**30
    t1 = time.perf_counter()
    try:
        with alloc_conf(TP_ALLOC_CONF):
            ranks = run_ranks(tp_train_rank, procs, args=(job,),
                              rendezvous_dir=phase["dir"],
                              timeout=phase["timeout"],
                              threads=SHARD_THREADS, nice=19)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        if references is None:
            drop_tp_references(kept)
    ranks_s = time.perf_counter() - t1
    print(f"  {procs} ranks on {grid_shape}: {ranks_s:.1f} s"
          + (f" ({free:.2f} GiB of the card free as they started)"
             if dev.type == "cuda" else ""), flush=True)

    agrid = ProcGrid.create_abstract(grid_shape, axes)
    rows = TRAIN_BATCH // batch_ranks(agrid)
    out = {"ranks_s": ranks_s, "models": {}}
    for arch, ref in refs.items():
        cfg = ref["cfg"]
        mb = phase["mb"].get(arch, TRAIN_MB)
        leaves = param_leaves(build(cfg, device="meta").init(None), agrid)
        acct = state_bytes(leaves, agrid, kind="train", microbatches=mb)
        model_coll = model_collectives(
            cfg, "train", leaves, agrid, batch=rows, seq=TRAIN_SEQ,
            microbatches=mb, batch_split=batch_ranks(agrid) > 1)
        if cfg.family == "moe":
            arith = ep_counted_bytes(cfg, leaves, agrid,
                                     tokens=rows // mb * TRAIN_SEQ,
                                     microbatches=mb)
        else:
            arith = tp_counted_bytes(
                cfg, leaves, agrid, tokens=rows // mb * TRAIN_SEQ,
                enc_tokens=rows // mb * cfg.enc_seq, microbatches=mb)
        res = {"microbatches": mb,
               "one_process": {k: ref[k] for k in (
                   "loss", "grad_norm", "exact_losses", "exact_norms")},
               "accounting": acct, "model_collectives": model_coll,
               "arithmetic": arith, "ranks": []}
        print(f"  {arch} ({cfg.n_layers} layers"
              + (f", {cfg.enc_layers} encoder layers" if cfg.enc_layers
                 else "") + f", d_model {cfg.d_model}, "
              + (f"{cfg.n_heads} heads, {cfg.n_kv} KV heads, "
                 if cfg.n_heads else "")
              + (f"{cfg.n_experts} experts top-{cfg.top_k}, "
                 if cfg.n_experts else "") + f"vocab {cfg.vocab}, "
              f"{cfg.dtype}, remat {cfg.remat!r}, {mb} microbatches of "
              f"{rows // mb * TRAIN_SEQ} tokens a rank):", flush=True)
        for r, o in enumerate(ranks):
            m = o["models"][arch]
            res["ranks"].append(m)
            h = m["history"]
            dts = [x["dt"] for x in h]
            steady = sum(dts[1:]) / len(dts[1:])
            m["steady_step_ms"] = steady * 1e3
            print(f"    rank {r} {o['coordinate']}"
                  + (f" heads [{m['heads'][0]}, {m['heads'][1]})"
                     if m["heads"] else "")
                  + (f" (KV heads {[kv for _, kv in m['kv_heads']]}), "
                     f"{m['experts']} experts" if "experts" in m else "")
                  + f": parameters {m['param_bytes']:,} B, AdamW state "
                  f"{m['opt_bytes']:,} B (accounting {acct['params']:,} and "
                  f"{acct['opt_state']:,}); peak "
                  f"{_gib(m['peak_bytes'] / 2**30)} (reserved "
                  f"{_gib(m['reserved_bytes'] / 2**30)}); step ms "
                  + ", ".join(f"{d * 1e3:.1f}" for d in dts)
                  + f", steady {steady * 1e3:.1f} ({tag}, {gpu}); "
                  "losses " + ", ".join(f"{x['loss']:.5f}" for x in h)
                  + (f"; checkpoint save {m['save_s']:.1f} s, restore "
                     f"{m['restore_s']:.1f} s" if arch == phase["ckpt"]
                     else "")
                  + f"; {m['seconds']:.1f} s", flush=True)
            check(m["placed"] and m["on_card"] and m["model_split"],
                  f"{arch} rank {r}: weights placed, {len(m['model_split'])}"
                  f" parameters split over \"model\", every tensor on "
                  f"{dev}")
            check(m["param_bytes"] == acct["params"] and
                  m["opt_bytes"] == acct["opt_state"],
                  f"{arch} rank {r}: parameter and AdamW state bytes equal "
                  f"the dry run's state_bytes on the abstract {grid_shape} "
                  "grid to the byte")
            check(all(c == arith for c in m["collectives_per_step"]),
                  f"{arch} rank {r}: the counted collective bytes of every "
                  f"step equal the arithmetic {arith} (counted "
                  f"{m['collectives_per_step']})")
            check(h[0]["loss"] == ranks[0]["models"][arch]["history"][0][
                "loss"], f"{arch} rank {r}: the same loss as rank 0")
            if arch == phase["ckpt"]:
                check(m["restored_step"] == TP_STEPS and
                      m["restored_bitwise"] and m["restored_local"],
                      f"{arch} rank {r}: the step-{TP_STEPS} checkpoint "
                      "(whole tensors) restored into this rank's blocks, "
                      "bitwise")
            if cfg.n_heads:
                c = o["coordinate"][axes.index("model")]
                H = cfg.n_heads
                check(tuple(m["heads"]) == (H * c // M, H * (c + 1) // M),
                      f"{arch} rank {r}: model rank {c} of {M} computes "
                      f"heads [{H} * {c} // {M}, {H} * {c + 1} // {M})")
            if "kv_heads" in m:
                G = cfg.n_heads // cfg.n_kv
                check([q for q, _ in m["kv_heads"]] == list(range(
                    *m["heads"])) and all(kv == q // G
                                          for q, kv in m["kv_heads"]),
                      f"{arch} rank {r}: local_kv gives query head h the "
                      f"keys of KV head h // {G} ({m['kv_heads']})")
            if "experts" in m:
                T = rows // mb * TRAIN_SEQ
                check(m["experts"] == cfg.n_experts and
                      m["moe_dispatch"] == [(1, T, False, False)],
                      f"{arch} rank {r}: all {cfg.n_experts} experts held "
                      f"and run on every model rank ({cfg.n_experts} % {M} "
                      f"= {cfg.n_experts % M}), each dispatch one global "
                      f"group of {T} tokens (groups, tokens, spread over "
                      f"ranks, experts split: {m['moe_dispatch']})")
        if cfg.n_heads:
            got = sorted(x for o in ranks for x in range(
                *o["models"][arch]["heads"]))
            check(got == sorted(list(range(cfg.n_heads)) * (procs // M)),
                  f"{arch}: the model ranks' head ranges cover each of the "
                  f"{cfg.n_heads} heads once")
        if cfg.family == "moe":
            whole = attn_whole(cfg, M, model_split_of(leaves), "layers")
            check(len(whole) == 4,
                  f"{arch}: the arithmetic takes wq, wo, wk and wv whole "
                  f"over \"model\" ({cfg.n_heads} % {M}, {cfg.n_kv} % {M} "
                  f"not 0): {len(whole)} weights")
        counted = ranks[0]["models"][arch]["collectives_per_step"][0]
        print(f"    collective operand bytes per step and device (counted "
              "on rank 0, step 1) vs the dry run's model_collectives: "
              + ", ".join(f"{k} {counted.get(k, 0):,} vs {model_coll[k]:,}"
                          f" ({counted.get(k, 0) - model_coll[k]:+,})"
                          for k in model_coll), flush=True)
        first = ranks[0]["models"][arch]["history"][0]
        dl = abs(first["loss"] - ref["loss"]) / abs(ref["loss"])
        dg = abs(first["grad_norm"] - ref["grad_norm"]) / \
            abs(ref["grad_norm"])
        res["full_width_agreement"] = {"loss_rel": dl, "grad_norm_rel": dg}
        print(f"    bf16 first step, placed vs one process: loss "
              f"{first['loss']:.6f} vs {ref['loss']:.6f} ({dl:.2e}), "
              f"grad_norm {first['grad_norm']:.6f} vs {ref['grad_norm']:.6f}"
              f" ({dg:.2e})", flush=True)
        ex = ranks[0]["models"][arch]["exact"]
        el = max(abs(a - b) / abs(b)
                 for a, b in zip(ex["losses"], ref["exact_losses"]))
        en = max(abs(a - b) / abs(b)
                 for a, b in zip(ex["norms"], ref["exact_norms"]))
        res["exact_agreement"] = {"loss_rel": el, "grad_norm_rel": en,
                                  "param_err": ex["param_err"],
                                  "first_moment_err": ex["first_moment_err"]}
        if "route_flips" in ex:
            gaps = [abs(g) for g in ex["flip_gaps"]]
            res["exact_agreement"].update(
                route_flips=ex["route_flips"],
                flip_gap_max=max(gaps, default=0.0))
        print(f"    float32 ({phase['models'][arch][1]}), {TP_EXACT_STEPS} "
              f"steps, placed vs one process: loss {el:.2e}, grad_norm "
              f"{en:.2e}, first moment {ex['first_moment_err'][0]:.2e} (at "
              f"{ex['first_moment_err'][1]}), parameters "
              f"{ex['param_err'][0]:.2e} (at {ex['param_err'][1]})"
              + (f"; {ex['route_flips']} (token, call) rows route otherwise"
                 " (replayed as one process routed)"
                 if "route_flips" in ex else ""), flush=True)
        out["models"][arch] = res
    for arch, res in out["models"].items():
        agree, ex = res["full_width_agreement"], res["exact_agreement"]
        lim_loss, lim_norm = phase["bf16_rtol"][arch]
        check(agree["loss_rel"] <= lim_loss and
              agree["grad_norm_rel"] <= lim_norm,
              f"{arch} bf16 placed vs one process, first step: loss "
              f"{agree['loss_rel']:.2e} <= {lim_loss:g}, grad_norm "
              f"{agree['grad_norm_rel']:.2e} <= {lim_norm:g}")
        if "route_flips" in ex:
            check(ex["flip_gap_max"] <= EP_TIE,
                  f"{arch} float32: {ex['route_flips']} (token, call) rows "
                  "route otherwise on the grid than in one process "
                  "(replayed as one process routed), each at a near tie: "
                  f"the K-th and (K+1)-th logits within "
                  f"{ex['flip_gap_max']:.2e} <= {EP_TIE:g}")
        lim = phase["exact_rtol"]
        check(ex["loss_rel"] <= lim and ex["grad_norm_rel"] <= lim and
              ex["first_moment_err"][0] <= SHARD_EXACT_RTOL and
              ex["param_err"][0] <= SHARD_EXACT_PARAM,
              f"{arch} float32, {TP_EXACT_STEPS} steps, placed vs one "
              f"process: loss {ex['loss_rel']:.2e}, grad_norm "
              f"{ex['grad_norm_rel']:.2e} <= {lim:g}; the first step's "
              f"gradient (first moment) {ex['first_moment_err'][0]:.2e} of "
              f"its largest <= {SHARD_EXACT_RTOL:g}; parameters "
              f"{ex['param_err'][0]:.2e} of the largest <= "
              f"{SHARD_EXACT_PARAM:g}")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    for o in ranks:
        for k, v in o["launches"].items():
            launches[k] += v
    out["launches"] = launches
    check(not any(launches.values()),
          f"the {phase['title']} launched no hand kernel: {launches}")
    out["seconds"] = time.perf_counter() - t0
    print(f"{name} phase: {out['seconds']:.1f} s (ranks {ranks_s:.1f} s)",
          flush=True)
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- the dry run
def dryrun_calibration(torch, gpu, tiny) -> dict:
    """The dry run's accounting of train_tinyllama's own step (8 x 1024
    tokens in 2 microbatches, remat "full", float32 m and v, a 1x1 grid)
    beside what the train phase measured of it: the state bytes held to
    the card's to the byte, the rest printed."""
    from repro_torch.configs.base import Shape, get_config
    from repro_torch.core.grid import ProcGrid
    from repro_torch.launch.dryrun import lower_step
    cfg = get_config(TRAIN_ARCH)
    rec = lower_step(cfg, Shape("train_tinyllama", "train", TRAIN_SEQ,
                                TRAIN_BATCH),
                     ProcGrid.create_abstract((1, 1), ("data", "model")),
                     microbatches=TRAIN_MB, opt_dtype=torch.float32)
    mem, card = rec["mem"], tiny["state_bytes_on_card"]
    acct = {"params_and_opt": mem["params"] + mem["opt_state"],
            "grads": mem["grads"], "accumulator": mem["accumulator"]}
    print(f"  calibration, {TRAIN_ARCH} train step ({TRAIN_BATCH}x"
          f"{TRAIN_SEQ} tokens, {TRAIN_MB} microbatches, remat "
          f"{cfg.remat!r}, float32 m and v): state bytes, accounting vs "
          "card: " + ", ".join(f"{k} {acct[k]:,} vs {card[k]:,}"
                               for k in acct), flush=True)
    check(acct == {k: card[k] for k in acct},
          "the accounting's state bytes (parameters, m, v and the step; "
          "gradients; float32 accumulator) equal the card's to the byte")
    steady_s = tiny["steady_step_ms"] / 1e3
    kernel_s = tiny["profile"]["kernel_ms"] / 1e3
    above = (tiny["peak_gib"] - tiny["allocated_before_gib"]) * 2**30
    out = {"flops": rec["flops"], "bytes_accessed": rec["bytes_accessed"],
           "aten_ops": rec["aten_ops"], "mem": mem,
           "peak_bytes": rec["peak_bytes_per_device"],
           "measured_peak_above_bytes": above,
           "steady_step_ms": tiny["steady_step_ms"],
           "kernel_ms": tiny["profile"]["kernel_ms"],
           "measured_aten_ops": tiny["profile"]["aten_ops"],
           "achieved_tflops_step": rec["flops"] / steady_s / 1e12,
           "achieved_tflops_kernel": rec["flops"] / kernel_s / 1e12,
           "bytes_bound_ms": rec["bytes_accessed"] / HBM_BYTES_PER_S * 1e3,
           "pass_s": rec["t_lower_s"], "state_bytes_on_card": card}
    print(f"  calibration ({gpu}): accounting {rec['flops']:.4e} FLOP, "
          f"{rec['bytes_accessed']:.4e} B accessed, {rec['aten_ops']:,} aten "
          f"ops (profiled step: {out['measured_aten_ops']:,} top-level); "
          f"measured steady step {out['steady_step_ms']:.1f} ms, kernel "
          f"time {out['kernel_ms']:.1f} ms: {out['achieved_tflops_step']:.1f}"
          f" TFLOP/s over the step, {out['achieved_tflops_kernel']:.1f} over "
          f"the kernel time; bytes_accessed / 3.35 TB/s = "
          f"{out['bytes_bound_ms']:.1f} ms; peak: accounting "
          f"{rec['peak_bytes_per_device'] / 2**30:.2f} GiB (activations "
          f"{mem['activations'] / 2**30:.2f}), measured above the earlier "
          f"phases {above / 2**30:.2f} GiB (gap "
          f"{(above - rec['peak_bytes_per_device']) / 2**30:+.2f})",
          flush=True)
    return out


def run_dryrun(torch, gpu, tiny) -> dict:
    """The dryrun phase (see DRYRUN_CELLS): the port's dry run on this
    machine, no card and no process group, then the calibration cell."""
    import math
    from repro_torch.launch.dryrun import lower_cell, lower_paper_workload
    from repro_torch.launch.mesh import make_abstract_production_grid
    out = {"paper": {}, "cells": {}}
    grids = {"single": make_abstract_production_grid(),
             "multi": make_abstract_production_grid(multi_pod=True)}
    for variant in ("planewave", "padded"):
        for gname, grid in grids.items():
            rec = lower_paper_workload(grid, variant=variant)
            out["paper"][f"{variant}|{gname}"] = {
                k: rec[k] for k in ("mesh", "flops", "bytes_accessed",
                                    "collective_total", "model_comm_bytes",
                                    "peak_bytes_per_device", "stages")}
            check(rec["flops"] > 0 and rec["collective_total"] > 0 and
                  rec["model_comm_bytes"][0]["bytes_per_device"] > 0,
                  f"paper cell {variant} on {rec['mesh']}: FLOPs, one "
                  "all-to-all")
    for arch, shape in DRYRUN_CELLS:
        rec = lower_cell(arch, shape, grids["single"])
        out["cells"][f"{arch}|{shape}"] = rec
        check(all(math.isfinite(rec[k]) and rec[k] > 0 for k in (
            "flops", "bytes_accessed", "collective_total",
            "peak_bytes_per_device")),
              f"{arch} x {shape} on {rec['mesh']}: finite, positive "
              "FLOPs, bytes, collectives and peak")
    check(out["cells"][f"{TRAIN_ARCH}|train_4k"]["n_params"] ==
          tiny["params"], f"{TRAIN_ARCH}: the accounting's parameter count "
          f"{tiny['params']:,} as trained on the card")
    out["calibration"] = dryrun_calibration(torch, gpu, tiny)
    return out


def run_examples(torch, gpu, wrappers) -> dict:
    """The examples phase: each examples/torch_*.py through its main() at
    its defaults on the card, with every kernel wrapper's count set to 0
    just before and read just after (the examples' "matmul" route
    reaches no hand kernel)."""
    import importlib.util
    import shutil
    import tempfile
    t0 = time.perf_counter()
    print(f"examples ({gpu}):", flush=True)
    for fn in wrappers.values():
        fn.launches = 0
    ckpt = tempfile.mkdtemp(prefix="example_ckpt_",
                            dir=os.path.join(HERE, "build"))

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f"example_{name}", os.path.join(HERE, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def quickstart(r):
        return {"rel_err": r["err"], "roundtrip_err": r["roundtrip"]}

    def planewave(r):
        return {"energy": r.energy, "iterations": r.iterations,
                "converged": r.converged, "device": r.device,
                "seconds": r.seconds}

    def serve_transforms(r):
        m = r["metrics"]
        return {"requests": m["requests"], "dispatches": m["dispatches"],
                "latency_p50_ms": m["latency_p50_ms"],
                "max_rel_err": r["max_rel_err"]}

    def mixer(r):
        return {"first_loss": r["losses"][0], "last_loss": r["losses"][-1]}

    def serve_lm(r):
        return {"requests": len(r), "tokens": sum(len(q.out) for q in r)}

    def train_lm(r):
        return {"steps": len(r), "first10": sum(r[:10]) / 10,
                "last10": sum(r[-10:]) / 10}

    runs = (("torch_quickstart", [], quickstart),
            ("torch_planewave_dft", [], planewave),
            ("torch_serve_transforms", [], serve_transforms),
            ("torch_fourier_mixer_lm", [], mixer),
            ("torch_serve_lm", [], serve_lm),
            ("torch_train_lm", ["--steps", str(EXAMPLE_TRAIN_STEPS),
                                "--ckpt-dir", ckpt], train_lm))
    out = {}
    try:
        for name, argv, numbers in runs:
            t1 = time.perf_counter()
            res = load(name).main(argv)
            sync(torch, torch.device("cuda"))
            out[name] = {**numbers(res), "seconds": time.perf_counter() - t1}
            print(f"  {name} {' '.join(argv)}: " + json.dumps(out[name]),
                  flush=True)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    check(out["torch_planewave_dft"]["device"].startswith("cuda"),
          "torch_planewave_dft computed on the card")
    launches = {k: fn.launches for k, fn in wrappers.items()}
    check(not any(launches.values()),
          f"the examples launched no hand kernel (expected 0): {launches}")
    wall = time.perf_counter() - t0
    check(wall <= EXAMPLES_MAX_S,
          f"examples phase {wall:.1f} s <= {EXAMPLES_MAX_S:g} s")
    print(f"examples phase: {wall:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return {"runs": out, "launches": launches, "seconds": wall}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.dft.basis import PlaneWaveBasis
        from repro_torch.kernels import build
        from repro_torch.kernels.dft_matmul import (dft_matmul,
                                                    dft_matmul_twiddle)
        from repro_torch.kernels.sphere_pack import dft_pack, unpack_dft
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable: {exc}",
              file=sys.stderr)
        return 2
    # full fp32 products in every plain version and library yardstick
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    if sys.argv[1:2] == ["--compare-kernel1"]:
        print(json.dumps({"compare_kernel1": compare_kernel1(
            torch, dev, sys.argv[2])}), flush=True)
        return 0
    gpu = gpu_line()
    print(f"gpu: {gpu}", flush=True)
    wrappers = {"dft_matmul": dft_matmul,
                "dft_matmul_twiddle": dft_matmul_twiddle,
                "unpack_dft": unpack_dft, "dft_pack": dft_pack}
    if sys.argv[1:2] == ["--production-grid"]:
        prod = run_tp_train(torch, dev, gpu, wrappers, "tp_production")
        print("tp_production: " + json.dumps(prod, default=str), flush=True)
        return 0
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    for stem, log in build.build_logs().items():
        for name, text in ptxas_summary(log):
            print(f"  ptxas {stem} {name}: {text}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    spheres = PlaneWaveBasis(N, diameter=DIAMETER, kpts=KPTS,
                             nbands=NBANDS, device=dev).spheres
    results = [check_dft_matmul(torch, dev, gen),
               check_unpack_dft(torch, dev, gen, spheres),
               check_dft_pack(torch, dev, gen, spheres)]
    for r in results[1:]:
        print(f"{r['name']}: " + json.dumps(r), flush=True)
    torch.cuda.empty_cache()
    stages = LineStages()
    t0 = time.perf_counter()
    launches, scf, ctx = run_slice(torch, dev, stages)
    print("scf: " + json.dumps(scf), flush=True)
    print(f"SCF phase: {time.perf_counter() - t0:.1f} s", flush=True)
    print("iteration breakdown (host clock, synchronized):", flush=True)
    scf["breakdown"] = breakdown(torch, dev)
    torch.cuda.empty_cache()
    scf["pack_slab"] = check_slab_layout(torch, dev, gen)
    print("pack_slab: " + json.dumps(scf["pack_slab"]), flush=True)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    modes = check_exec_modes(torch, dev, gen)
    print("exec_modes: " + json.dumps(modes), flush=True)
    print(f"executor-mode phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lazy = run_lazy_scf(torch, dev, ctx)
    print("scf_lazy: " + json.dumps(lazy), flush=True)
    print(f"lazy SCF phase: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fused = run_fused_step(torch, dev, ctx)
    print("scf_fused: " + json.dumps(fused), flush=True)
    print(f"fused-step phase: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    multirank = run_multirank(torch, dev, ctx, gpu)
    print("multirank: " + json.dumps(multirank), flush=True)
    print(f"multi-rank phase: {time.perf_counter() - t0:.1f} s", flush=True)
    del ctx
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    twiddle, four_step = check_four_step(torch, dev, gen, stages)
    results.append(twiddle)
    launches["dft_matmul_twiddle"] = four_step["launches"][
        "dft_matmul_twiddle"]
    print("four_step: " + json.dumps(four_step), flush=True)
    print(f"four-step phase: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    service, served = check_service(torch, dev, gpu, stages)
    print("service: " + json.dumps(service), flush=True)
    print(f"service phase: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mr_service = run_multirank_service(torch, dev, gpu, served)
    del served
    print("multirank_service: " + json.dumps(mr_service), flush=True)
    print(f"multi-rank service phase: {time.perf_counter() - t0:.1f} s",
          flush=True)

    t0 = time.perf_counter()
    paper = run_paper(torch, dev, gen, gpu)
    print("paper: " + json.dumps(paper), flush=True)
    print(f"paper phase: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    print("spectral layers:", flush=True)
    spectral = check_spectral(torch, dev, gen, stages)
    print("spectral: " + json.dumps(spectral), flush=True)
    print(f"spectral phase: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    print(f"LM serving path ({gpu}):", flush=True)
    for fn in wrappers.values():
        fn.launches = 0
    lm = check_lm(torch, dev, gpu)
    lm["launches"] = {k: fn.launches for k, fn in wrappers.items()}
    check(not any(lm["launches"].values()),
          "the LM path launched no hand kernel (the reference's LM path "
          f"reaches no Pallas kernel): {lm['launches']}")
    print("lm: " + json.dumps(lm), flush=True)
    print(f"lm phase: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    train = run_train(torch, dev, gpu, wrappers)
    print("train: " + json.dumps(train), flush=True)
    sharded = run_sharded_train(torch, dev, gpu, wrappers)
    print("sharded_train: " + json.dumps(sharded), flush=True)
    ep = run_ep_train(torch, dev, gpu, wrappers)
    print("ep_train: " + json.dumps(ep), flush=True)
    references = {}
    try:
        tp_run = run_tp_train(torch, dev, gpu, wrappers,
                              references=references)
        print("tp_train: " + json.dumps(tp_run, default=str), flush=True)
        uneven = run_tp_train(torch, dev, gpu, wrappers, "tp_uneven",
                              references)
        print("tp_uneven: " + json.dumps(uneven, default=str), flush=True)
    finally:
        drop_tp_references(references)

    t0 = time.perf_counter()
    print(f"dry run (meta device, abstract grids; calibration on {gpu}):",
          flush=True)
    dry = run_dryrun(torch, gpu, train["tinyllama"])
    print("dryrun: " + json.dumps(dry), flush=True)
    print(f"dryrun phase: {time.perf_counter() - t0:.1f} s", flush=True)
    examples = run_examples(torch, gpu, wrappers)
    print("examples: " + json.dumps(examples), flush=True)

    t0 = time.perf_counter()
    shapes = time_line_shapes(torch, dev, gen, stages, gpu)
    print("line_shapes: " + json.dumps(shapes), flush=True)
    print(f"line-shape phase: {time.perf_counter() - t0:.1f} s", flush=True)

    sources = {"dft_matmul": ("src/repro_torch/kernels/csrc/dft_matmul.cu",
                              "src/repro/kernels/dft_matmul.py:32"),
               "dft_matmul_twiddle": (
                   "src/repro_torch/kernels/csrc/dft_matmul.cu",
                   "src/repro/kernels/dft_matmul.py:51"),
               "unpack_dft": ("src/repro_torch/kernels/csrc/sphere_pack.cu",
                              "src/repro/kernels/sphere_pack.py:134"),
               "dft_pack": ("src/repro_torch/kernels/csrc/sphere_pack.cu",
                            "src/repro/kernels/sphere_pack.py:175")}
    per_call = paper["launches_per_call"]
    by_path = {"scf": {k: v for k, v in launches.items()
                       if k != "dft_matmul_twiddle"},
               "four_step": four_step["launches"],
               "service": service["launches"],
               "paper_inverse_and_forward": {
                   k: per_call["inverse"][k] + per_call["forward"][k]
                   for k in per_call["inverse"]},
               "spectral": {"dft_matmul": sum(
                   r["launches"] for r in spectral.values())},
               "lm": lm["launches"], "train": train["launches"],
               "sharded_train": sharded["launches"],
               "ep_train": ep["launches"],
               "tp_train": tp_run["launches"],
               "tp_uneven": uneven["launches"],
               "examples": examples["launches"]}
    # the multi-rank paths' launches, per rank (each a list over the
    # ranks): the fused steps count the warm-up's and the capture's
    per_rank = {"multirank_scf_per_rank": multirank["launches_per_rank"],
                "multirank_fused_scf_per_rank": multirank["fused"][
                    "launches_per_rank"],
                "multirank_service_per_rank": mr_service[
                    "launches_per_rank"],
                "pencil_scf_per_rank": multirank["pencil"][
                    "launches_per_rank"],
                "pencil_fused_scf_per_rank": multirank["pencil"]["fused"][
                    "launches_per_rank"]}
    kernels = []
    for r in results:
        src, rep = sources[r["name"]]
        kernels.append({"name": r["name"], "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[r["name"]],
                        "launches_by_path": {
                            **{p: c.get(r["name"], 0)
                               for p, c in by_path.items()},
                            **{p: [c.get(r["name"], 0) for c in runs]
                               for p, runs in per_rank.items()}},
                        "passed": True, **{k: r[k] for k in (
                            "max_abs_err", "rel_err", "tolerance", "ms",
                            "plain_ms", "bound_ms", "bound_by",
                            "tf32x3_bound_ms", "tf32x3_bound_by",
                            "fp32_fma_bound_ms", "fp32_fma_bound_by",
                            "library_ms", "shape")},
                        **({"fft_oracle_rel_err": r["fft_oracle_rel_err"]}
                           if "fft_oracle_rel_err" in r else {})})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        sys.exit(1)
