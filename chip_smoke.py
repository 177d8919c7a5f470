#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --production-grid

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
and prints each kernel's ``-Xptxas -v`` summary, runs the LM stack's
phases below, and last times the FFT kernels alone at the benchmark
cells' shapes.  The FFT kernels and paths are checked on the card by the
cases of ``tests/test_torch_cuda.py``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

and timed end to end by the benchmark (``portbench/``, ``BENCHMARK.json``).

The LM phase, the reference's LM serving path through the port's
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

Last, the FFT kernels alone at the cells' shapes, one 128-band call each
(``BENCH_LINE_STAGES``, ``time_sphere_calls``): kernel #1 at the six line
stages of ``paper-pair`` and ``gw-mtxel``, through the entry each stage
takes (rows, or the strided entry, then beside the rows entry on the same
lines and checked bit for bit against it), in its factored mode beside the
dense product through the same entry, complex64 ``torch.matmul`` (which it
must beat) and the plain versions of both modes (which they must match);
then kernel #3 at the cells' unpack of the 128-sphere and kernel #4 at each
cell's pack, onto the 128-sphere and onto the 64-sphere, from the z-major
slab the forward leaves, in the factored mode the cells take beside the
dense one, each on its first 8 bands against the plain version of its
mode; then the Γ fold and unfold at ``gamma-pair``'s call (256 real bands
on the half sphere, 128 complex rows) against their plain versions on the
same inputs, bit for bit; then one call pair of each cell through the
port's main path (``unpack_transform`` and ``transform_pack``;
``pair_density``), every kernel wrapper's count set to 0 just before: four
launches of #1, one of #3, one of #4 and none of #2 (``gamma-pair`` also
one fold and one unfold, the others none), #3 and #4 each once in the
factored mode and never in the dense one, and the paper and Γ pairs'
round trips within 1e-5;
then kernel #2 at stage 1 of ``four_step_dft`` (4096 lines of 4096, which
no cell runs) against its plain version and the einsum of the same
function (which it must beat); each time against its roofline bound, the
benchmark's (``portbench/roofline.py``).

Exits non-zero, printing no result line, on any failed check or when no
CUDA device is present.

Printed, in order: the card's name and power limit, the kernel build time
and each kernel's ``-Xptxas -v`` summary (registers, spills),
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
the kernel-alone tables, the cells' call pairs (``cell_pairs:``), one
``{"kernels": [...]}`` line (per kernel, mode and shape: the launches in
each cell's call pair, the error against the plain version and its
tolerance, ms, the roofline bound and share, the library's ms), and last
the device JSON line.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0

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

# H100 SXM published peak (NVIDIA data sheet): HBM, the LM phases' bound
# of reading every weight once (the FFT kernels' yardstick is
# portbench/roofline.py's)
HBM_BYTES_PER_S = 3.35e12

# kernel #1's factored mode vs its plain version: 3xTF32 against complex64
# products, two stages and a twiddle each (3.3-4.2e-7 measured on the H100)
FACTORED_RTOL = 2e-6


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
            m = re.search(r"cgemm_tc_factored_(sphere_)?kernelILi(\d)ELi"
                          r"(\d+)ELi(\d+)E(?:N4dftk(\d+)(\w+))?", name)
            if m:
                policy = f", {m[6][:int(m[5])]}" if m[5] else ""
                name = (f"cgemm_tc_factored_{m[1] or ''}kernel<"
                        f"{A_PATHS[int(m[2])]}, {m[3]}, {m[4]}{policy}>")
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


def roofline(ms: float, work: tuple[float, float]) -> dict:
    """A kernel call's time against the benchmark's yardstick
    (``portbench/roofline.py``: the problem's bytes, each read or written
    once, and its FFT operations, not the algorithm's), ``work`` its
    ``(bytes, operations)``: the bound in ms, what sets it, and the share
    of it the call reached."""
    from portbench.roofline import bound_s
    nbytes, flops = work
    bound = bound_s(nbytes, flops) * 1e3
    by = ("bytes" if bound_s(nbytes, 0.0) >= bound_s(0.0, flops)
          else "operations")
    return {"bound_ms": bound, "bound_by": by, "roofline": bound / ms}


def roofline_text(r: dict) -> str:
    return (f"roofline bound {r['bound_ms']:.3f} ms ({r['bound_by']}), "
            f"{100 * r['roofline']:.1f}% of it")


def rel_err(got, want) -> float:
    """The largest error over the largest |want|."""
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def crandn(torch, gen, shape, device):
    re = torch.randn(shape, generator=gen, device=device)
    im = torch.randn(shape, generator=gen, device=device)
    return torch.complex(re, im)


def _gib(x) -> str:
    return "not measured" if x is None else f"{x:.2f} GiB"


# ------------------------------------------------- the FFT kernels alone
#: kernel #1's stages in the benchmark's cells, one 128-band call each:
#: the paper pair's idft[x], idft[y], dft[Y], dft[X] and gw-mtxel's
#: dft[Y], dft[X] onto the 64-sphere, as (lines, n_in, n_out, inverse, L),
#: L the lines a plane of the strided entry (1: rows).  Every one is a
#: factored stage (its longer length is 256)
BENCH_LINE_STAGES = ((4194304, 128, 256, True, 32768),
                     (8388608, 128, 256, True, 65536),
                     (8388608, 256, 128, False, 1),
                     (4194304, 256, 128, False, 128),
                     (8388608, 256, 64, False, 1),
                     (2097152, 256, 64, False, 64))
#: lines on which the plain version of a stage is timed (its complex64
#: intermediates at a whole stage would not fit beside it)
PLAIN_LINES = 1 << 20
#: the cells' grid, sphere and bands a plan call: n = 256, d = 128
#: (gw-mtxel's forward onto d = 64), 128 bands (gamma-pair: 256 real
#: bands, two a complex row, on the Γ sphere of d = 128)
BENCH_N, BENCH_D, BENCH_D_EPS, BENCH_BANDS = 256, 128, 64, 128
#: the dense kernels (#1's dense mode, #2, #3, #4) against their plain
#: versions: split-TF32 products against fp32 GEMMs summed in another order
KERNEL_RTOL = 1e-5
#: the first bands of a 128-band call on which #3 and #4 are held against
#: their plain versions (the plain unpack's gathers at 128 bands would not
#: fit beside the kernel's output)
SPHERE_PLAIN_BANDS = 8
#: the sphere kernels' calls by mode in one call pair of either cell: both
#: take the factored mode (``kernels/sphere_pack.py::MODES``)
PAIR_MODES = {"unpack_factored": 1, "unpack_dense": 0, "pack_factored": 1,
              "pack_dense": 0}
#: the launches of one call pair of paper-pair or gw-mtxel: each
#: direction's z stage fused into #3 or #4, its y and x stages on #1, no
#: four-step stage (``portbench/roofline.py::pair_calls``), no Γ pass
PAIR_LAUNCHES = {"dft_matmul": 4, "dft_matmul_twiddle": 0, "unpack_dft": 1,
                 "dft_pack": 1, "gamma_fold": 0, "gamma_unfold": 0}
#: gamma-pair's: the same transforms on the Γ sphere, the fold before the
#: inverse and the unfold after the forward
GAMMA_LAUNCHES = {**PAIR_LAUNCHES, "gamma_fold": 1, "gamma_unfold": 1}
#: the fold and the unfold against their plain versions: gathers with one
#: add and one product by 0.5 an output, so the two agree bit for bit;
#: this is the bound a difference must stay under
GAMMA_RTOL = 1e-6
#: kernel #2 at stage 1 of ``four_step_dft`` on this many lines of this
#: length (no cell runs it: ``four_step_dft`` is the reference's path for
#: lines longer than a dense matrix allows)
FOUR_STEP_LINES, FOUR_STEP_N = 4096, 4096


def bitwise(torch, a, b) -> bool:
    return bool(torch.equal(torch.view_as_real(a), torch.view_as_real(b)))


def line_entry(torch, gen, dev, M, n_in, n_out, inverse, L):
    """Kernel #1 as a factored line stage launches it on ``M`` random
    lines: ``(kernel, rows, dense, lines, w, ws, fo)``, ``kernel`` the
    entry the stage takes (rows, or for ``L`` > 1 the strided entry on
    ``(M / L, n_in, L)`` planes), ``rows`` the rows entry on the same
    lines in rows (``kernel`` itself when L = 1), ``dense`` the dense
    product through the same entry as ``kernel``, ``lines`` the lines as
    ``(M, n_in)`` rows (a view when L = 1, a copy otherwise), ``w`` the
    DFT matrix, ``ws`` its split operand, ``fo`` the factored operands."""
    from repro_torch.core.local_fft import dft_matrix_device
    from repro_torch.kernels.dft_matmul import (dft_factored,
                                                dft_factored_cols,
                                                dft_matmul, dft_matmul_cols,
                                                factored_split)
    from repro_torch.kernels.ops import (dft_operand_device,
                                         factored_operands_device)
    check(factored_split(n_in, n_out) is not None,
          f"{n_in}->{n_out} is a factored stage")
    _, _, w = dft_matrix_device(n_out, n_in, inverse, dev)
    ws = dft_operand_device(n_out, n_in, inverse, w.device)
    fo = factored_operands_device(n_out, n_in, bool(inverse), w.device)
    if L == 1:
        x = lines = crandn(torch, gen, (M, n_in), dev)
        dense = lambda: dft_matmul(x, w, wsplit=ws)
    else:
        x = crandn(torch, gen, (M // L, n_in, L), dev)
        lines = x.transpose(1, 2).contiguous().view(M, n_in)
        dense = lambda: dft_matmul_cols(x, w, wsplit=ws)
    on_rows = lambda: dft_factored(lines, fo)
    kernel = on_rows if L == 1 else lambda: dft_factored_cols(x, fo)
    return kernel, on_rows, dense, lines, w, ws, fo


def time_line_shapes(torch, dev, gen, gpu: str) -> list:
    """Kernel #1 at the benchmark's stages (``BENCH_LINE_STAGES``),
    through the entry each takes: its time against its roofline bound,
    beside complex64 ``torch.matmul`` on the same lines (which it must
    beat); for the strided entry, the rows entry on the same lines in
    rows, the two checked bit for bit; the dense product through the same
    entry, and the plain versions on ``PLAIN_LINES`` lines, the factored
    mode checked against its own and the dense mode's rows entry against
    ``dft_matmul_plain``."""
    from portbench.roofline import line_call
    from repro_torch.kernels.dft_matmul import (dft_factored,
                                                dft_factored_plain,
                                                dft_matmul, dft_matmul_plain)
    print(f"kernel #1 at the cells' line stages ({gpu}; CUDA events, mean "
          "of 10):", flush=True)
    rows = []
    for key in BENCH_LINE_STAGES:
        M, n_in, n_out, inverse, L = key
        kernel, on_rows, dense, lines, w, ws, fo = line_entry(
            torch, gen, dev, *key)
        ms = time_ms(torch, kernel)
        row = {"lines": M, "n_in": n_in, "n_out": n_out, "inverse": inverse,
               "entry": "strided" if L > 1 else "rows", "L": L, "ms": ms,
               "rows_ms": None, "bitwise": None}
        if L > 1:
            row["rows_ms"] = time_ms(torch, on_rows)
            row["bitwise"] = bitwise(torch, kernel(), on_rows())
            check(row["bitwise"], f"kernel #1 {M}x{n_in}->{n_out}: the "
                  f"strided entry (L = {L}) gives the rows entry's bits")
        row["dense_ms"] = time_ms(torch, dense)
        part = lines[:PLAIN_LINES]
        row["plain_lines"] = part.shape[0]
        row["plain_ms"] = time_ms(
            torch, lambda: dft_factored_plain(part, fo), reps=3)
        row["rel_err"] = rel_err(dft_factored(part, fo),
                                 dft_factored_plain(part, fo))
        check(row["rel_err"] <= FACTORED_RTOL,
              f"kernel #1 {M}x{n_in}->{n_out} factored against its "
              f"plain version: {row['rel_err']:.2e} <= {FACTORED_RTOL}")
        row["dense_rel_err"] = rel_err(dft_matmul(part, w, wsplit=ws),
                                       dft_matmul_plain(part, w))
        check(row["dense_rel_err"] <= KERNEL_RTOL,
              f"kernel #1 {M}x{n_in}->{n_out} dense against its plain "
              f"version: {row['dense_rel_err']:.2e} <= {KERNEL_RTOL}")
        row["matmul_ms"] = time_ms(torch, lambda: torch.matmul(lines, w.T))
        check(ms < row["matmul_ms"], f"kernel #1 {M}x{n_in}->{n_out} "
              f"{ms:.3f} ms faster than complex64 torch.matmul "
              f"{row['matmul_ms']:.3f} ms")
        del kernel, on_rows, dense, lines, w, ws, fo, part
        row["work"] = line_call(M, n_in, n_out)
        row.update(roofline(ms, row["work"]))
        rows.append(row)
        entry_txt = ("rows" if L == 1 else
                     f"strided L={L} (rows {row['rows_ms']:.3f} ms, "
                     f"{ms / row['rows_ms']:.3f}x; bitwise "
                     f"{row['bitwise']})")
        print(f"  {M}x{n_in}->{n_out}{' inv' if inverse else ''} "
              f"{entry_txt}: {ms:.3f} ms factored (dense "
              f"{row['dense_ms']:.3f} ms, rel err "
              f"{row['dense_rel_err']:.2e}; plain {row['plain_ms']:.3f} ms "
              f"on {row['plain_lines']} lines, rel err "
              f"{row['rel_err']:.2e}), {roofline_text(row)}, torch.matmul "
              f"{row['matmul_ms']:.3f} ms", flush=True)
        torch.cuda.empty_cache()
    return rows


def cell_plans(torch, dev) -> dict:
    """Each cell's plan pair for one call on one process, on the "cuda"
    backend: ``paper-pair``'s ``make_planewave_pair`` and ``gw-mtxel``'s
    ``mtxel_plans`` of 128 bands, ``gamma-pair``'s ``gamma_plans`` of 256
    real bands (128 complex rows), as the benchmark's drivers make
    them."""
    from repro_torch.core import ProcGrid, gamma_plans, make_planewave_pair
    from repro_torch.core.planewave import kpoint_sphere
    from repro_torch.dft import cutoff_sphere, mtxel_plans
    n, d, B = BENCH_N, BENCH_D, BENCH_BANDS
    grid = ProcGrid.create([1], device=dev)
    return {"paper-pair": make_planewave_pair(
                grid, n, kpoint_sphere(d), B, backend="cuda"),
            "gw-mtxel": mtxel_plans(grid, n, kpoint_sphere(d),
                                    cutoff_sphere(BENCH_D_EPS), B,
                                    backend="cuda"),
            "gamma-pair": gamma_plans(grid, n, d, 2 * B, backend="cuda")}


def time_sphere_calls(torch, dev, gen, gpu: str, pairs: dict) -> list:
    """Kernels #3 and #4 at one 128-band call of each cell, on the line
    tables and operators of the cells' own plans (``cell_plans``): #3 at
    the inverse's unpack of the 128-sphere (the same in both cells), #4 at
    ``paper-pair``'s pack onto the 128-sphere and at ``gw-mtxel``'s onto
    the 64-sphere about G = 0, each from the z-major slab (layout 2) its
    forward's x stage leaves; each in the factored mode the plans take and
    in the dense mode, its time against its roofline bound, and the call's
    first ``SPHERE_PLAIN_BANDS`` bands against the plain version of the
    mode, within ``FACTORED_RTOL`` or ``KERNEL_RTOL``."""
    from portbench.roofline import pack_call, unpack_call
    from repro_torch.kernels import sphere_pack as sp
    from repro_torch.kernels.ops import dft_operand_device
    n, d, B, b = BENCH_N, BENCH_D, BENCH_BANDS, SPHERE_PLAIN_BANDS
    print(f"kernels #3 and #4 at a 128-band call of each cell ({gpu}; CUDA "
          "events, mean of 10):", flush=True)
    out = []

    def report(kernel, mode, cells, shape, ms, work, got, want):
        err = rel_err(got, want)
        tol = FACTORED_RTOL if mode == "factored" else KERNEL_RTOL
        check(bool(torch.isfinite(torch.view_as_real(got)).all())
              and err <= tol, f"{kernel} {mode} {shape}: the first {b} "
              f"bands finite and within {err:.2e} <= {tol} of the plain "
              "version")
        out.append({"kernel": kernel, "mode": mode, "cells": cells,
                    "shape": shape, "ms": ms, "rel_err": err,
                    "tolerance": tol, "plain_bands": b, "work": work,
                    **roofline(ms, work)})
        print(f"  {kernel} {mode} {shape} ({', '.join(cells)}): {ms:.3f} "
              f"ms, {roofline_text(out[-1])}; rel err {err:.2e} on {b} "
              "bands", flush=True)

    ip = pairs["paper-pair"][0]._fused_in_parts()
    start, zlo, cnt, flag = ip["private"][:4]
    fo, w = ip["factored"], ip["w"]
    check(fo is not None, "the cells' unpack takes the factored mode")
    modes = {"factored": {"factored": fo},
             "dense": {"chunks": sp.chunk_ranges(zlo, cnt, flag),
                       "wsplit": dft_operand_device(n, d, True, dev)}}
    rows = crandn(torch, gen, ip["in_shape"], dev)
    npk = rows.shape[1]
    work = unpack_call(B, npk, int((cnt[0] > 0).sum()), d, n)
    for mode, kw in modes.items():
        def unpack():
            return sp.unpack_dft(rows, start, zlo, cnt, flag, w, **kw)
        ms = time_ms(torch, unpack)
        got = unpack()[:b].clone()
        want = sp.unpack_dft_plain(rows[:b], start[:b], zlo[:b], cnt[:b],
                                   flag, w, kw.get("factored"))
        report("unpack_dft", mode, [c for c in pairs if c != "gamma-pair"],
               f"({B},{npk})->({B},{d},{d},{n})", ms, work, got, want)
        del got, want
        torch.cuda.empty_cache()
    del rows
    for cell, (_, fwd) in pairs.items():
        if cell == "gamma-pair":        # the Γ sphere's #4: in the pair
            continue
        fp = fwd._fused_out_parts()
        start, zlo, cnt, nvalid = fp["private"]
        npk, w, fo = fp["out_shape"][1], fp["w"], fp["factored"]
        ds = w.shape[0]
        check(fo is not None, f"{cell}: the pack takes the factored mode")
        slab = crandn(torch, gen, (B, n, ds, ds), dev).permute(0, 3, 2, 1)
        check(sp.slab_layout(slab) == 2, f"{cell}: the z-major slab is "
              "read in place (layout 2)")
        work = pack_call(B, npk, int((cnt[0] > 0).sum()), n)
        modes = {"factored": {"factored": fo},
                 "dense": {"wsplit": dft_operand_device(ds, n, False, dev)}}
        for mode, kw in modes.items():
            def pack():
                return sp.dft_pack(slab, start, zlo, cnt, nvalid, w, npk,
                                   **kw)
            ms = time_ms(torch, pack)
            got = pack()[:b]
            want = sp.dft_pack_plain(slab[:b], start[:b], zlo[:b], cnt[:b],
                                     nvalid[:b], w, npk, kw.get("factored"))
            report("dft_pack", mode, [cell], f"({B},{ds},{ds},{n}) z-major->"
                   f"({B},{npk})", ms, work, got, want)
            del got, want
        del slab
        torch.cuda.empty_cache()
    return out


def gamma_bands(torch, gen, inv, dev):
    """Seeded real-band coefficients on the Γ plan's half sphere, its
    G = 0 lane (the half's first) real."""
    c = crandn(torch, gen, (inv.local_nbands, inv.nhalf), dev)
    c[:, 0] = c[:, 0].real.to(c.dtype)
    return c


def time_gamma_passes(torch, dev, gen, gpu: str, pairs: dict) -> list:
    """The fold and the unfold at ``gamma-pair``'s call (256 real bands on
    the half sphere, 128 complex rows of the full one), on its plan's
    lane tables: each against its plain version on the same card inputs
    (bit for bit, and within ``GAMMA_RTOL``), timed against its roofline
    bound (the call's half-sphere rows and full-sphere rows, each read or
    written once: ``drivers/gamma.py::fold_work``, half of it a pass)."""
    from portbench.drivers.gamma import fold_work
    from repro_torch.kernels import gamma as gk
    from repro_torch.kernels.ref import gamma_fold_plain, gamma_unfold_plain
    inv, _ = pairs["gamma-pair"]
    lane, mirror = inv._lane, inv._mirror
    nb, nh, npk = inv.local_nbands, inv.nhalf, inv.sphere.npacked
    rows = -(-nb // 2)
    work = (fold_work(nh, npk, nb) / 2, 0.0)
    half = gamma_bands(torch, gen, inv, dev)
    full = crandn(torch, gen, (rows, npk), dev)
    passes = {
        "gamma_fold": (lambda: gk.fold(half, lane, mirror, npk),
                       lambda: gamma_fold_plain(half, lane, mirror, npk),
                       f"({nb},{nh})->({rows},{npk})"),
        "gamma_unfold": (lambda: gk.unfold(full, lane, mirror, nb),
                         lambda: gamma_unfold_plain(full, lane, mirror, nb),
                         f"({rows},{npk})->({nb},{nh})")}
    print(f"the Γ fold and unfold at gamma-pair's call ({gpu}; CUDA events, "
          "mean of 10):", flush=True)
    out = []
    for name, (kernel, plain, shape) in passes.items():
        got, want = kernel(), plain()
        same = bitwise(torch, got, want)
        err = rel_err(got, want)
        check(same or err <= GAMMA_RTOL, f"{name} {shape}: bit for bit, "
              f"or within {err:.2e} <= {GAMMA_RTOL} of the plain version")
        del got, want
        ms = time_ms(torch, kernel)
        out.append({"kernel": name, "shape": shape, "ms": ms,
                    "rel_err": err, "bitwise": same, "work": work,
                    **roofline(ms, work)})
        print(f"  {name} {shape}: {ms:.3f} ms, {roofline_text(out[-1])}; "
              f"{'bit for bit' if same else f'rel err {err:.2e}'}",
              flush=True)
    del half, full
    torch.cuda.empty_cache()
    return out


def run_cell_pairs(torch, dev, gen, gpu: str, pairs: dict,
                   wrappers: dict) -> dict:
    """One call pair of each cell through the port's main path, as the
    benchmark's drivers call it (``paper-pair`` and ``gamma-pair``:
    ``unpack_transform`` then ``transform_pack``; ``gw-mtxel``:
    ``pair_density`` against one valence band), after a first pair that
    builds every shape, with every kernel wrapper's count set to 0 just
    before and read just after: the launches must be ``PAIR_LAUNCHES``
    (``GAMMA_LAUNCHES`` for ``gamma-pair``) and the sphere kernels' modes
    ``PAIR_MODES``, and ``paper-pair``'s and ``gamma-pair``'s pairs must
    give back their coefficients within ``KERNEL_RTOL``.  Returns each
    cell's launches and modes (the pairs' times are the benchmark's)."""
    from repro_torch.dft import pair_density, valence_conjugates
    from repro_torch.kernels.sphere_pack import MODES
    print(f"one call pair of each cell through the main path ({gpu}):",
          flush=True)
    out = {}
    for cell, (inv, fwd) in pairs.items():
        if cell == "gamma-pair":
            c = gamma_bands(torch, gen, inv, dev)
        else:
            shape = inv._fused_in_parts()["in_shape"]
            c = crandn(torch, gen, shape, dev)
        if cell == "gw-mtxel":
            vconj = valence_conjugates(inv, fwd, crandn(
                torch, gen, (1, shape[1]), dev))[0]
            pair = lambda: pair_density(inv, fwd, c, vconj)
        else:
            pair = lambda: fwd.transform_pack(inv.unpack_transform(c))
        pair()
        sync(torch, dev)
        for fn in wrappers.values():
            fn.launches = 0
        modes0 = dict(MODES)
        got = pair()
        sync(torch, dev)
        launches = {k: fn.launches for k, fn in wrappers.items()}
        modes = {k: MODES[k] - modes0[k] for k in MODES}
        want = GAMMA_LAUNCHES if cell == "gamma-pair" else PAIR_LAUNCHES
        check(launches == want, f"{cell}: one call pair launched "
              f"{launches}")
        check(modes == PAIR_MODES, f"{cell}: one call pair's sphere "
              f"kernels by mode {modes}")
        err = None
        if cell != "gw-mtxel":
            err = rel_err(got, c)
            check(err <= KERNEL_RTOL, f"{cell}: the pair gives back its "
                  f"coefficients within {err:.2e} <= {KERNEL_RTOL}")
        out[cell] = {"launches": launches, "modes": modes,
                     "round_trip_rel_err": err}
        del c, got, pair
        vconj = None
        torch.cuda.empty_cache()
    return out


def time_twiddle(torch, dev, gen, gpu: str) -> dict:
    """Kernel #2 at stage 1 of ``four_step_dft`` on FOUR_STEP_LINES lines
    of FOUR_STEP_N (the (n1, n2) table): against its plain version within
    ``KERNEL_RTOL``, and timed beside the library einsum that computes the
    same function, which it must beat, against its roofline bound (the
    line stage's, plus the table read once and a complex product an
    output)."""
    import numpy as np

    from portbench.roofline import line_call
    from repro_torch.core.local_fft import dft_matrix_device
    from repro_torch.kernels import ops
    from repro_torch.kernels.dft_matmul import (dft_matmul_twiddle,
                                                dft_matmul_twiddle_plain)
    from repro_torch.kernels.ref import twiddle_matrix
    n1, n2 = ops._factor(FOUR_STEP_N)
    M, K, Nn = FOUR_STEP_LINES * n1, n2, n2
    x = crandn(torch, gen, (M, K), dev)
    _, _, w = dft_matrix_device(Nn, K, False, dev)
    ws = ops.dft_operand_device(Nn, K, False, w.device)
    t = torch.as_tensor(np.ascontiguousarray(
        twiddle_matrix(n1, n2, False).T), device=dev)
    xb = x.view(M // n1, n1, K)

    def library():
        return torch.einsum("btk,nk,tn->btn", xb, w, t).reshape(M, Nn)

    def kernel():
        return dft_matmul_twiddle(x, w, t, wsplit=ws)
    want = dft_matmul_twiddle_plain(x, w, t)
    err = rel_err(kernel(), want)
    shape = f"{M}x{K}->{Nn} t({n1},{n2})"
    check(err <= KERNEL_RTOL, f"kernel #2 {shape} against its plain "
          f"version: {err:.2e} <= {KERNEL_RTOL}")
    del want
    ms = time_ms(torch, kernel)
    lib = time_ms(torch, library)
    check(ms < lib, f"kernel #2 {shape} {ms:.3f} ms faster than the library "
          f"einsum {lib:.3f} ms")
    nbytes, flops = line_call(M, K, Nn)
    work = (nbytes + 8.0 * n1 * Nn, flops + 6.0 * M * Nn)
    out = {"shape": shape, "ms": ms, "rel_err": err, "library_ms": lib,
           "work": work, **roofline(ms, work)}
    print(f"kernel #2 at stage 1 of four_step_dft, {shape} ({gpu}): "
          f"{ms:.3f} ms, {roofline_text(out)}, library einsum {lib:.3f} ms; "
          f"rel err {err:.2e}", flush=True)
    return out


def kernel_table(lines: list, sphere: list, gamma: list, twiddle: dict,
                 cells: dict) -> list:
    """The ``kernels`` line: one entry a kernel, mode and shape, each
    with the kernel's launches in each cell's call pair (``cells``, from
    ``run_cell_pairs``), its error against its plain version and the
    tolerance, its time, its roofline bound and the library's time where
    one torch call computes the same function (``torch.matmul`` for #1,
    einsum for #2; none for #3, #4, the fold and the unfold)."""
    def launches(name):
        return {cell: r["launches"][name] for cell, r in cells.items()}
    out = []
    for r in lines:
        shape = (f"{r['lines']}x{r['n_in']}->{r['n_out']}"
                 f"{' inv' if r['inverse'] else ''} {r['entry']}")
        base = {"name": "dft_matmul", "shape": shape,
                "launches": launches("dft_matmul"),
                "library_ms": r["matmul_ms"]}
        out.append({**base, "mode": "factored", "rel_err": r["rel_err"],
                    "tolerance": FACTORED_RTOL, "ms": r["ms"],
                    **{k: r[k] for k in ("bound_ms", "bound_by",
                                         "roofline")}})
        out.append({**base, "mode": "dense", "rel_err": r["dense_rel_err"],
                    "tolerance": KERNEL_RTOL, "ms": r["dense_ms"],
                    **roofline(r["dense_ms"], r["work"])})
    out.append({"name": "dft_matmul_twiddle", "mode": "dense",
                "shape": twiddle["shape"],
                "launches": launches("dft_matmul_twiddle"),
                "library_ms": twiddle["library_ms"],
                "tolerance": KERNEL_RTOL,
                **{k: twiddle[k] for k in ("rel_err", "ms", "bound_ms",
                                           "bound_by", "roofline")}})
    for r in sphere:
        side = "unpack" if r["kernel"] == "unpack_dft" else "pack"
        out.append({"name": r["kernel"], "mode": r["mode"],
                    "shape": r["shape"], "cells": r["cells"],
                    "launches": launches(r["kernel"]),
                    "mode_launches": {
                        cell: c["modes"][f"{side}_{r['mode']}"]
                        for cell, c in cells.items()},
                    "library_ms": None,
                    **{k: r[k] for k in ("rel_err", "tolerance", "ms",
                                         "bound_ms", "bound_by",
                                         "roofline")}})
    for r in gamma:
        out.append({"name": r["kernel"], "mode": "gather",
                    "shape": r["shape"], "cells": ["gamma-pair"],
                    "launches": launches(r["kernel"]), "library_ms": None,
                    "tolerance": GAMMA_RTOL,
                    **{k: r[k] for k in ("rel_err", "bitwise", "ms",
                                         "bound_ms", "bound_by",
                                         "roofline")}})
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


def run_fft_kernels(torch, dev, gpu: str, wrappers: dict) -> None:
    """The FFT kernels alone at the cells' shapes, then one call pair of
    each cell through the main path; prints the ``cell_pairs:`` and
    ``kernels`` lines."""
    from repro_torch.kernels.gamma import fold, unfold
    wrappers = {**wrappers, "gamma_fold": fold, "gamma_unfold": unfold}
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lines = time_line_shapes(torch, dev, gen, gpu)
    pairs = cell_plans(torch, dev)
    sphere = time_sphere_calls(torch, dev, gen, gpu, pairs)
    gamma = time_gamma_passes(torch, dev, gen, gpu, pairs)
    cells = run_cell_pairs(torch, dev, gen, gpu, pairs, wrappers)
    del pairs
    torch.cuda.empty_cache()
    twiddle = time_twiddle(torch, dev, gen, gpu)
    print("cell_pairs: " + json.dumps(cells), flush=True)
    print(json.dumps({"kernels": kernel_table(lines, sphere, gamma, twiddle,
                                              cells)}), flush=True)
    print(f"kernel-alone phase: {time.perf_counter() - t0:.1f} s",
          flush=True)


def main() -> int:
    import torch
    if sys.argv[1:] not in ([], ["--production-grid"]):
        print(f"usage: {sys.argv[0]} [--production-grid]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
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

    run_fft_kernels(torch, dev, gpu, wrappers)
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
