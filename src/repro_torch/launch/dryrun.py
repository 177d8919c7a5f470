"""Multi-pod dry run of the port: an accounting of every (arch × shape ×
grid) cell on the ``meta`` device (the reference's ``launch/dryrun.py``).

The reference lowers and compiles each cell for 512 forced host devices
and reads XLA's ``memory_analysis``, ``cost_analysis`` and the collectives
of the optimized HLO.  PyTorch has no such compiler, so here each cell is
an accounting: the model is built on ``meta`` (shapes and dtypes, no
storage), and the cell's step runs once on one rank's local batch under
one ``TorchDispatchMode`` that sees every aten op.  Nothing is allocated,
and no card and no process group are needed.  The grids are abstract
(:func:`~repro_torch.launch.mesh.make_abstract_production_grid`).

A record holds, per device:

* ``flops``: matmul, convolution and attention FLOPs, counted by the
  formulas of ``torch.utils.flop_counter``.  XLA's ``flops`` also count
  elementwise work, so the two are not the same quantity.
* ``bytes_accessed``: the sum over every aten op of its input and output
  bytes, views counted as 0.  That is what the eager port moves, because
  each op is a kernel; it is not a fused lower bound.
* Both come from a pass over one rank's local batch with the whole
  weights (``flops_rank``, ``bytes_accessed_rank``: what a data-parallel
  rank of the port runs) divided by the size of the "model" axis, over
  which the reference's specs split every product (tensor and expert
  parallelism).
* ``mem``: parameters, gradients, the float32 microbatch accumulator
  (made only when there are several microbatches) and the optimizer state
  (m, v and the step) under ``rules.param_specs`` on the grid: each
  leaf's bytes divided by the product of the sizes of its spec's axes.
  The cache under ``rules.cache_specs``.  Activations: the bytes the
  forward saves for backward (``torch.autograd.graph.saved_tensors_hooks``,
  each storage once, parameters left out) for one microbatch, divided by
  the model axis for train and prefill (the reference's sequence
  parallelism).  Prefill and decode run under ``inference_mode`` and
  save nothing; their transients are not counted.
* ``peak_bytes_per_device``: the sum of ``mem``.
* ``collective_bytes``: modelled (``"collective_model": "reference
  specs"``): the accounting runs one rank's step on whole weights on the
  ``meta`` device, where no collective runs.  The placed train step on a
  grid of processes (``sharding/rules.py::place_params``) runs these
  collectives and counts their operand bytes in
  ``core/grid.py::COLLECTIVE_BYTES``; PERF.md §5 holds the model to those
  counts for TinyLlama and for Granite-MoE (expert parallelism) on 2×2.  The reference's five names and its
  operand convention (``collective_bytes``' docstring): all-gather operand =
  result / participants, reduce-scatter operand = result × participants.
  For a parameter leaf p (the reference's leaf, stacked layers included)
  of B_p bytes and N_p elements whose spec splits it S_p ways, F_p of them
  over its FSDP axes ("pod", "data") and M_p = S_p / F_p over the rest;
  mb microbatches; passes P = 2 + (remat ≠ "none") for train (forward,
  backward, recompute), 1 for prefill and decode; T the tokens of one
  microbatch on one rank (encoder leaves: frames); a the activations'
  bytes per element:

  - all-gather (FSDP weights): P · mb · Σ_{F_p>1} B_p / S_p;
  - reduce-scatter (gradients, train): mb · Σ_{F_p>1} B_p / M_p;
  - all-reduce: gradients of the leaves with F_p = 1 over the batch axes
    when they split the batch (train, once a step, float32):
    Σ_{F_p=1} 4 · N_p / M_p + 4 (the loss); tensor parallelism: for every
    leaf whose input dim (its second-to-last) the model axis splits
    (row-parallel projections, the vocab-parallel embedding),
    P · mb · layers_p · T · d_out · a; decode with a cache that splits
    head_dim over the model axis: the scores, layers · B · n_heads ·
    capacity · 4;
  - all-to-all (expert parallelism, MoE leaves whose experts the model
    axis splits): 2 · P · mb · layers_p · T · top_k · d_model · a, the
    routed tokens of a step whose tokens the model axis splits (sequence
    parallelism, which the reference's dry run turns on and the port's
    train step does not yet read).  Without it the hidden state is whole
    on every model rank: each rank dispatches its own experts' slots
    locally and the partial combines are all-reduced over "model", as
    the reference's compiled step does (no all-to-all; PERF.md §5 and
    §7);
  - collective-permute: 0 (no pipeline stage in the reference's rules).

Left out of the reference's record, having no counterpart: ``mem.code``
and ``mem.alias`` (no compiled program) and ``t_compile_s``
(``t_lower_s`` is the accounting pass's wall time).  Tokens and labels
are int64, where the reference's are int32: the port's ``torch.gather``
and embedding lookups take int64.

The paper's workload (fftb-paper: batched plane-wave FFT 256³, sphere
d = 128, 256 bands) is a cell of its own: its plan on the abstract grid,
FLOPs from ``core/local_fft.py::dft_flops`` per stage on the local
blocks, bytes as each stage's reads and writes, and the plan's own
``comm_stats()``.

Results go to ``experiments/dryrun_torch.json`` (the reference's file is
``experiments/dryrun.json``), stored after every cell, so an interrupted
sweep resumes.

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--force]
  python -m repro_torch.launch.dryrun --paper [--paper-variant padded]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import (ARCH_IDS, SHAPES, Shape, applicable,
                                      get_config)
from repro_torch.launch.mesh import make_abstract_production_grid
from repro_torch.models.model_zoo import build, reference_name, stacked_lists
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import rules
from repro_torch.train.train_step import init_opt_state, make_train_step

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch.json")

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1,
                "f8e5m2": 1, "s64": 8, "u64": 8, "s32": 4, "u32": 4,
                "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1, "c64": 8,
                "c128": 16}

_COLL = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
_FSDP_AXES = ("pod", "data")


def collective_bytes(hlo: str) -> dict[str, int]:
    """Per-device *operand* bytes of every collective in optimized HLO
    (a copy of the reference's parser, so the reference's HLO records can
    be read here).

    Optimized HLO prints operands by name only, so sizes are derived from
    the RESULT type: all-reduce/all-to-all/collective-permute results equal
    their operands; all-gather operands are result/participants;
    reduce-scatter operands are result×participants.  Participant counts
    come from replica_groups (explicit {{...}} or iota [G,P]<=[N] form).
    """
    out: dict[str, int] = {c: 0 for c in _COLL}
    shape_re = re.compile(r"(\w+)\[([0-9,]*)\]")
    line_re = re.compile(
        r"=\s*((?:\([^=]*?\))|(?:\S+))\s+"
        r"(all-reduce|all-gather|reduce-scatter|all-to-all|"
        r"collective-permute)(-start)?\(")
    for line in hlo.splitlines():
        m = line_re.search(line)
        if not m:
            continue
        restype, op, start = m.group(1), m.group(2), m.group(3)
        total = 0
        for dt, dims in shape_re.findall(restype):
            if dt not in _DTYPE_BYTES:
                continue
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            total += n * _DTYPE_BYTES[dt]
        if start and restype.startswith("("):
            total //= 2          # async start returns (operand, result)
        p = 1
        g = re.search(r"replica_groups=\{\{([0-9, ]+)\}", line)
        if g:
            p = len(g.group(1).split(","))
        else:
            g = re.search(r"replica_groups=\[(\d+),(\d+)\]<=", line)
            if g:
                p = int(g.group(2))
        if op == "all-gather" and p:
            total //= p
        elif op == "reduce-scatter":
            total *= p
        out[op] += total
    return out


# --------------------------------------------------------------- inputs
def _act_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _inputs(cfg, kind: str, batch: int, seq: int) -> dict:
    """Meta tensors for one step of ``kind`` over ``batch`` rows."""
    def ids(*shape):
        return torch.empty(shape, dtype=torch.int64, device="meta")

    def emb(*shape):
        return torch.empty(shape, dtype=_act_dtype(cfg), device="meta")

    if kind == "decode":        # one new token against a cache of seq
        return {"tokens": ids(batch, 1), "lengths": ids(batch)}
    text = seq - cfg.n_img_tokens if cfg.family == "vlm" else seq
    out = {"tokens": ids(batch, text)}
    if kind == "train":
        out["labels"] = ids(batch, text)
    if cfg.family == "vlm":     # image tokens replace part of the sequence
        out["image_embeds"] = emb(batch, cfg.n_img_tokens, cfg.d_model)
    if cfg.family == "encdec":
        out["frames"] = emb(batch, cfg.enc_seq, cfg.d_model)
    return out


def input_specs(arch: str, shape_name: str) -> dict:
    """Meta-tensor stand-ins for every model input of the cell, at the
    global batch (the reference's ``ShapeDtypeStruct``s; ids int64)."""
    shape = SHAPES[shape_name]
    return _inputs(get_config(arch), shape.kind, shape.batch, shape.seq)


# --------------------------------------------------------- sizing rules
def opt_state_dtype(n_params: int, n_devices: int) -> torch.dtype:
    """The reference's optimizer-state dtype: bfloat16 m and v once
    float32 ones would pass ~40% of a device, ``n_params × 10 B /
    devices > 6.5 GiB`` (8-bit-Adam style), else float32."""
    if n_params * 10 / n_devices > 6.5 * 2**30:
        return torch.bfloat16
    return torch.float32


def _dp_size(grid) -> int:
    return math.prod(grid.shape[grid.axis_index(a)]
                     for a in _FSDP_AXES if a in grid.axes)


def microbatch_count(cfg, shape: Shape, grid) -> int:
    """The reference's microbatch count: about 16k tokens per device per
    microbatch (4k for d_model ≥ 8192, or for an MoE whose top_k · d_ff
    passes 4 · d_model), reduced until it divides the local batch."""
    b_loc = max(shape.batch // _dp_size(grid), 1)
    budget = 16384 if cfg.d_model < 8192 else 4096
    if cfg.family == "moe" and cfg.top_k * cfg.d_ff > 4 * cfg.d_model:
        budget = 4096
    mb = max(1, (b_loc * shape.seq) // budget)
    while b_loc % mb:
        mb -= 1
    return mb


def local_batch(shape: Shape, grid) -> int:
    """The rows one rank holds: the batch split over the batch axes where
    ``rules.batch_axis`` splits it, else all of it (replicated)."""
    axes = rules.batch_axis(grid, shape.batch)
    return shape.batch // _dp_size(grid) if axes else shape.batch


# ------------------------------------------------------------ the pass
_METADATA = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "size", "stride", "sym_size",
             "sym_stride", "numel", "sym_numel", "dim", "is_contiguous",
             "storage_offset", "sym_storage_offset"}


def _nbytes(x) -> int:
    """Bytes of the tensors in ``x`` (a tensor, or lists, tuples and
    dicts of them: an aten op's arguments and results)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    return 0


class _Counter(TorchDispatchMode):
    """Counts every aten op: FLOPs by ``torch.utils.flop_counter``'s
    formulas, and input plus output bytes of every op that is not a view
    (nor an allocation or a metadata query).  Composite ops count as the
    ops they decompose into."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.atomic = set()         # ops found to have no decomposition

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet not in self.registry and func not in self.atomic:
            # a composite op (under inference_mode they reach the mode
            # whole) is counted by the ops it decomposes into, as
            # FlopCounterMode counts it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
            self.atomic.add(func)
        out = func(*args, **kwargs)
        if func.is_view or packet.__name__ in _METADATA:
            return out
        self.ops += 1
        count = self.registry.get(packet)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def _count(fn, params, *, inference: bool) -> dict:
    """Run ``fn()`` under the counter and, with gradients on, a saved-
    tensors hook that sums each saved storage once (parameters aside)."""
    own = {p.untyped_storage()._cdata for p in params.parameters()}
    saved: dict[int, int] = {}
    held = []           # keeps each counted storage alive, so no id reuses

    def pack(t):
        st = t.untyped_storage()
        if st._cdata not in own and st._cdata not in saved:
            saved[st._cdata] = st.nbytes()
            held.append(st)
        return t

    t0 = time.perf_counter()
    with _Counter() as c:
        if inference:
            with torch.inference_mode():
                fn()
        else:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                fn()
    # the pass runs on the meta device: no device work to wait for
    seconds = time.perf_counter() - t0  # noqa: FFTB204
    return {"flops": c.flops, "bytes_accessed": c.bytes, "ops": c.ops,
            "saved_bytes": sum(saved.values()), "seconds": seconds}


def _meta_model(cfg):
    bundle = build(cfg, device="meta")
    return bundle, bundle.init(torch.Generator())


def count_pass(cfg, kind: str, batch: int, seq: int, *,
               microbatches: int = 1,
               opt_dtype: torch.dtype = torch.float32, model=None) -> dict:
    """One rank's step of ``kind`` on ``batch`` rows, counted on ``meta``
    (no grid): train runs ``make_train_step`` (no grid, ``microbatches``,
    AdamW state in ``opt_dtype``), prefill ``bundle.prefill`` into a
    bfloat16 cache of capacity ``seq``, decode one ``bundle.decode`` step
    against it.  ``model``: the ``(bundle, params)`` of :func:`_meta_model`
    to reuse.  ``saved_bytes`` is per microbatch."""
    bundle, params = model or _meta_model(cfg)
    ins = _inputs(cfg, kind, batch, seq)
    if kind == "train":
        opt = init_opt_state(params, dtype=opt_dtype)
        step = make_train_step(bundle, AdamWConfig(),
                               microbatches=microbatches)
        out = _count(lambda: step(params, opt, ins), params, inference=False)
        out["saved_bytes"] //= microbatches
        return out
    with torch.inference_mode():
        cache = bundle.init_cache(batch, seq, torch.bfloat16)
    if kind == "prefill":
        return _count(lambda: bundle.prefill(params, ins, cache), params,
                      inference=True)
    return _count(lambda: bundle.decode(params, ins["tokens"], cache,
                                        ins["lengths"]), params,
                  inference=True)


# ---------------------------------------------------- specs and bytes
def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _split(spec, grid, keep=None) -> int:
    """How many ways ``spec`` splits a tensor on ``grid`` (over the axes
    for which ``keep`` holds, all when None)."""
    return math.prod(grid.shape[grid.axis_index(a)]
                     for e in spec for a in _axes(e)
                     if keep is None or keep(a))


def param_leaves(model, grid) -> list[dict]:
    """The reference's parameter leaves of ``model`` (stacked layers
    joined on a leading axis): path, shape, element size and spec on
    ``grid``."""
    lists = stacked_lists(model)
    specs = rules.param_specs(model, grid)
    leaves: dict[str, dict] = {}
    for name, p in model.named_parameters():
        ref, idx = reference_name(name, lists)
        shape = tuple(p.shape) if idx is None else \
            (len(getattr(model, ref.partition(".")[0])),) + tuple(p.shape)
        leaves.setdefault(ref, {"path": tuple(ref.split(".")),
                                "shape": shape, "itemsize": p.element_size(),
                                "spec": specs[name]})
    return list(leaves.values())


def _leaf_bytes(leaf) -> int:
    return math.prod(leaf["shape"]) * leaf["itemsize"]


def state_bytes(leaves, grid, *, kind: str, microbatches: int = 1,
                opt_dtype: torch.dtype = torch.float32) -> dict:
    """Per-device bytes of the parameters and, for train, the gradients,
    the float32 accumulator (several microbatches only) and the AdamW
    state (m, v and the int32 step) under the leaves' specs."""
    opt_size = torch.empty((), dtype=opt_dtype).element_size()
    params = grads = acc = opt = 0
    for leaf in leaves:
        split = _split(leaf["spec"], grid)
        n = math.prod(leaf["shape"])
        params += _leaf_bytes(leaf) // split
        if kind == "train":
            grads += _leaf_bytes(leaf) // split
            acc += 4 * n // split if microbatches > 1 else 0
            opt += 2 * opt_size * n // split
    if kind == "train":
        opt += 4                                # the step counter
    return {"params": params, "grads": grads, "accumulator": acc,
            "opt_state": opt}


def cache_bytes(cfg, batch: int, capacity: int, grid) -> int:
    """Per-device bytes of a bfloat16 cache of ``batch`` slots under
    ``rules.cache_specs``."""
    cache = build(cfg, device="meta").init_cache(batch, capacity,
                                                 torch.bfloat16)
    specs = rules.cache_specs(cfg, batch, grid, cache)

    def walk(c, s):
        if isinstance(c, dict):
            return sum(walk(c[k], s[k]) for k in c)
        return c.numel() * c.element_size() // _split(s, grid)
    return walk(cache, specs)


# ---------------------------------------------------------- collectives
def _model_size(grid) -> int:
    return grid.shape[grid.axis_index("model")] if "model" in grid.axes \
        else 1


def _fsdp(a) -> bool:
    return a in _FSDP_AXES


def fsdp_all_gather(leaves, grid, *, passes: int, microbatches: int) -> int:
    """All-gather operand of the FSDP-sharded weights, each gathered once
    a pass and microbatch: P · mb · Σ_{F_p>1} B_p / S_p."""
    return passes * microbatches * sum(
        _leaf_bytes(lf) // _split(lf["spec"], grid) for lf in leaves
        if _split(lf["spec"], grid, _fsdp) > 1)


def grad_reduce_scatter(leaves, grid, *, microbatches: int) -> int:
    """Reduce-scatter operand of those weights' gradients, once a
    microbatch: mb · Σ_{F_p>1} B_p / M_p."""
    return microbatches * sum(
        _leaf_bytes(lf) // _split(lf["spec"], grid, lambda a: not _fsdp(a))
        for lf in leaves if _split(lf["spec"], grid, _fsdp) > 1)


def grad_all_reduce(leaves, grid, *, batch_split: bool) -> int:
    """All-reduce of the other leaves' float32 gradients and the loss over
    the batch axes, once a step, when they split the batch:
    Σ_{F_p=1} 4 · N_p / M_p + 4."""
    if not batch_split:
        return 0
    return 4 + sum(4 * math.prod(lf["shape"]) // _split(lf["spec"], grid)
                   for lf in leaves if _split(lf["spec"], grid, _fsdp) == 1)


def _is_encoder(leaf) -> bool:
    return leaf["path"][0].startswith("enc")


def tp_all_reduce(leaves, grid, *, passes: int, microbatches: int,
                  tokens: int, enc_tokens: int, act_bytes: int) -> int:
    """All-reduce of the partial sums of every leaf whose input dim (its
    second-to-last) the model axis splits: P · mb · layers_p · T · d_out ·
    a (T: ``enc_tokens`` for encoder leaves)."""
    total = 0
    for lf in leaves:
        spec, shape = lf["spec"], lf["shape"]
        if len(shape) < 2 or "model" not in _axes(
                spec[-2] if len(spec) >= 2 else None):
            continue
        t = enc_tokens if _is_encoder(lf) else tokens
        total += math.prod(shape[:-2]) * t * shape[-1] * act_bytes
    return passes * microbatches * total


def ep_all_to_all(leaves, grid, cfg, *, passes: int, microbatches: int,
                  tokens: int, act_bytes: int) -> int:
    """All-to-all of the routed tokens (dispatch and combine) of every MoE
    layer whose experts the model axis splits: 2 · P · mb · layers_p · T ·
    top_k · d_model · a (under sequence parallelism; see the module
    docstring)."""
    total = 0
    for lf in leaves:
        spec, shape = lf["spec"], lf["shape"]
        if "moe" not in lf["path"] or lf["path"][-1] != "w_up" or \
                len(spec) < 3 or "model" not in _axes(spec[-3]):
            continue
        total += math.prod(shape[:-3]) * tokens * cfg.top_k * cfg.d_model \
            * act_bytes
    return 2 * passes * microbatches * total


def score_all_reduce(cfg, grid, *, batch: int, capacity: int) -> int:
    """Decode against a cache that splits head_dim over the model axis:
    the scores' partial sums, layers · B · n_heads · capacity · 4."""
    cache = build(cfg, device="meta").init_cache(batch, capacity,
                                                 torch.bfloat16)
    specs = rules.cache_specs(cfg, batch, grid, cache)
    total = 0
    for name in ("k", "xk"):
        spec = specs.get(name)
        if spec and "model" in _axes(spec[-1]):
            leaf = cache[name]
            total += leaf.shape[0] * batch * cfg.n_heads * leaf.shape[2] * 4
    return total


def model_collectives(cfg, kind: str, leaves, grid, *, batch: int, seq: int,
                      microbatches: int = 1, batch_split: bool) -> dict:
    """The five collectives' per-device operand bytes of one step (the
    module docstring's formulas)."""
    train = kind == "train"
    passes = 2 + (cfg.remat != "none") if train else 1
    mb = microbatches
    rows = batch // mb
    tokens = rows if kind == "decode" else rows * seq
    enc = rows * cfg.enc_seq if kind != "decode" else 0
    a = _act_dtype(cfg).itemsize
    live = [lf for lf in leaves if not (kind == "decode" and _is_encoder(lf))]
    out = {c: 0 for c in _COLL}
    out["all-gather"] = fsdp_all_gather(live, grid, passes=passes,
                                        microbatches=mb)
    if train:
        out["reduce-scatter"] = grad_reduce_scatter(leaves, grid,
                                                    microbatches=mb)
        out["all-reduce"] = grad_all_reduce(leaves, grid,
                                            batch_split=batch_split)
    if _model_size(grid) > 1:
        out["all-reduce"] += tp_all_reduce(
            live, grid, passes=passes, microbatches=mb, tokens=tokens,
            enc_tokens=enc, act_bytes=a)
        out["all-to-all"] = ep_all_to_all(live, grid, cfg, passes=passes,
                                          microbatches=mb, tokens=tokens,
                                          act_bytes=a)
        if kind == "decode":
            out["all-reduce"] += score_all_reduce(cfg, grid, batch=batch,
                                                  capacity=seq)
    return out


# ---------------------------------------------------------------- cells
def _shape(shape) -> Shape:
    return shape if isinstance(shape, Shape) else SHAPES[shape]


def _mesh_name(grid) -> str:
    return "x".join(str(s) for s in grid.shape)


def lower_step(cfg, shape: Shape, grid, *, microbatches: int = 1,
               opt_dtype: torch.dtype = torch.float32,
               passes: dict | None = None, model=None) -> dict:
    """The accounting of one step of ``shape`` for ``cfg`` on ``grid``,
    with the microbatch count and optimizer dtype given (the lower level
    of :func:`lower_cell`).  ``passes`` memoizes the counted pass by its
    inputs (config, kind, local batch, sequence, microbatches, optimizer
    dtype), so another grid with the same local step reuses it.
    ``model`` as in :func:`count_pass`."""
    model = model or _meta_model(cfg)
    b_loc = local_batch(shape, grid)
    key = (cfg, shape.kind, b_loc, shape.seq, microbatches, opt_dtype)
    passes = {} if passes is None else passes
    if key not in passes:
        passes[key] = count_pass(cfg, shape.kind, b_loc, shape.seq,
                                 microbatches=microbatches,
                                 opt_dtype=opt_dtype, model=model)
    ps = passes[key]
    params = model[1]
    leaves = param_leaves(params, grid)
    mem = state_bytes(leaves, grid, kind=shape.kind,
                      microbatches=microbatches, opt_dtype=opt_dtype)
    tp = _model_size(grid)
    mem["cache"] = (cache_bytes(cfg, b_loc, shape.seq, grid)
                    if shape.kind != "train" else 0)
    mem["activations"] = ps["saved_bytes"] // tp
    coll = model_collectives(
        cfg, shape.kind, leaves, grid, batch=b_loc, seq=shape.seq,
        microbatches=microbatches,
        batch_split=rules.batch_axis(grid, shape.batch) is not None)
    return {
        "mesh": _mesh_name(grid), "n_devices": grid.nprocs,
        "flops": ps["flops"] / tp, "bytes_accessed": ps["bytes_accessed"] / tp,
        "flops_rank": ps["flops"], "bytes_accessed_rank": ps["bytes_accessed"],
        "aten_ops": ps["ops"],
        "collective_bytes": coll,
        "collective_total": float(sum(coll.values())),
        "collective_model": "reference specs",
        "mem": mem, "peak_bytes_per_device": sum(mem.values()),
        "n_params": sum(p.numel() for p in params.parameters()),
        "local_batch": b_loc, "microbatches": microbatches,
        "opt_dtype": str(opt_dtype).replace("torch.", ""),
        "t_lower_s": ps["seconds"],
        "method": "meta-device accounting",
    }


def lower_cell(arch: str, shape_name: str, grid, *, verbose=True,
               cfg_override=None, mb_override=None, opt_override=None,
               passes: dict | None = None) -> dict:
    """The cell's accounting at the reference's sizing rules
    (:func:`microbatch_count`, :func:`opt_state_dtype`).  ``shape_name``
    names one of ``SHAPES`` or is a :class:`Shape`."""
    cfg = cfg_override or get_config(arch)
    shape = _shape(shape_name)
    model = _meta_model(cfg)
    mb, opt_dtype = 1, torch.float32
    if shape.kind == "train":
        mb = microbatch_count(cfg, shape, grid)
        opt_dtype = opt_state_dtype(
            sum(p.numel() for p in model[1].parameters()), grid.nprocs)
    mb = mb_override or mb
    opt_dtype = opt_override or opt_dtype
    rec = {"arch": arch, "shape": shape.name,
           **lower_step(cfg, shape, grid, microbatches=mb,
                        opt_dtype=opt_dtype, passes=passes, model=model)}
    if verbose:
        print(f"[{rec['mesh']}] {arch} × {shape_name}: "
              f"flops={rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e} "
              f"coll={rec['collective_total']:.3e} "
              f"peak={rec['peak_bytes_per_device'] / 2**30:.2f}GiB "
              f"(mb {mb}, pass {rec['t_lower_s']:.1f}s)", flush=True)
    return rec


def account_cell(arch: str, shape_name: str, grid, *, verbose=True,
                 cfg_override=None, passes: dict | None = None) -> dict:
    """The reference's extrapolated accounting: the cell at depths L=1 and
    L=2 (hybrid: one and two block groups), every cost linear in depth:
    ``cost(L) = cost(1) + (cost(2) − cost(1))·(L − 1)``, at the full
    config's microbatch count and optimizer dtype.  The port's layers are
    Python loops, so :func:`lower_cell` gives the full-depth count too."""
    cfg = cfg_override or get_config(arch)
    shape = _shape(shape_name)
    if cfg.family == "hybrid":
        plen = len(cfg.block_pattern)
        depths, l_full = (plen, 2 * plen), cfg.n_layers // plen
    else:
        depths, l_full = (1, 2), cfg.n_layers
    mb, opt_dtype = None, None
    if shape.kind == "train":
        mb = microbatch_count(cfg, shape, grid)
        opt_dtype = opt_state_dtype(
            sum(p.numel() for p in _meta_model(cfg)[1].parameters()),
            grid.nprocs)
    recs = [lower_cell(arch, shape_name, grid, verbose=False,
                       cfg_override=dataclasses.replace(
                           cfg, n_layers=L,
                           enc_layers=min(cfg.enc_layers, L)
                           if cfg.enc_layers else 0),
                       mb_override=mb, opt_override=opt_dtype, passes=passes)
            for L in depths]
    r1, r2 = recs
    steps = l_full - 1

    def extra(key):
        if isinstance(r1[key], dict):
            return {k: r1[key][k] + (r2[key][k] - r1[key][k]) * steps
                    for k in r1[key]}
        return r1[key] + (r2[key] - r1[key]) * steps

    out = {"arch": arch, "shape": shape.name, "mesh": r1["mesh"],
           "n_devices": r1["n_devices"],
           **{k: extra(k) for k in ("flops", "bytes_accessed",
                                    "collective_bytes", "collective_total")},
           "collective_model": "reference specs",
           "depths": list(depths), "l_full": l_full,
           "method": "L1L2-extrapolation"}
    if cfg.family == "hybrid" and cfg.n_layers % len(cfg.block_pattern):
        # 38 = 12 groups + 2 tail rec layers: scale by true/extrapolated
        scale = cfg.n_layers / (l_full * len(cfg.block_pattern))
        for k in ("flops", "bytes_accessed", "collective_total"):
            out[k] *= scale
        out["collective_bytes"] = {k: v * scale
                                   for k, v in out["collective_bytes"].items()}
        out["tail_scale"] = scale
    if verbose:
        print(f"[{out['mesh']}] acct {arch} × {shape_name}: "
              f"flops={out['flops']:.3e} bytes={out['bytes_accessed']:.3e} "
              f"coll={out['collective_total']:.3e}", flush=True)
    return out


# ---------------------------------------------------- the paper workload
def _stage_walk(plan) -> list[dict]:
    """Each stage of ``plan`` on one device's local block: kind, input and
    output elements, and for a line-DFT stage its lines and lengths."""
    from repro_torch.core import layout as L
    from repro_torch.core.plan import FFTStage
    sizes = dict(zip(plan.tin.dims, plan.tin.shape))
    lay = L.normalize(plan.tin.layout)
    shape = plan.grid.shape

    def local(d):
        return L.local_size(d, sizes[d], lay, shape)

    out = []
    for st in plan.stages:
        elems = math.prod(local(d) for d in plan.dims)
        if isinstance(st, FFTStage):
            lines = elems // local(st.dim)
            out.append({"stage": f"DFT[{st.dim}] {st.n_in}->{st.n_out}",
                        "lines": lines, "n_in": st.n_in, "n_out": st.n_out,
                        "in": elems, "out": lines * st.n_out,
                        "backend": st.backend})
            sizes[st.dim] = st.n_out
        else:
            out.append({"stage": f"a2a[{st.axis_name}] {st.src}->{st.dst}",
                        "in": elems, "out": elems})
            ax = plan.grid.axis_index(st.axis_name)
            lay = L.apply_move(lay, L.Move(ax, st.src, st.dst))
    return out


def lower_paper_workload(grid, *, verbose=True, backend="matmul",
                         variant="planewave") -> dict:
    """The paper's Fig. 9 workload as a dry-run cell, on ``grid``.

    variant: planewave (staged pad, batched) | padded (full-cube baseline).
    ``backend`` "pallas" is the port's "cuda"."""
    from repro_torch.configs.fftb_paper import CONFIG as PC
    from repro_torch.core import (DistTensor, Domain, FftPlan, SphereDomain,
                                  make_planewave_pair)
    from repro_torch.core.local_fft import dft_flops
    backend = "cuda" if backend == "pallas" else backend
    fft_axes = tuple(i for i, a in enumerate(grid.axes) if a == "model")
    batch_axes = tuple(i for i, a in enumerate(grid.axes) if a != "model")
    t0 = time.perf_counter()
    if variant == "planewave":
        sph = SphereDomain.from_diameter(PC.diameter)
        inv, _ = make_planewave_pair(grid, PC.n, sph, PC.nb, backend=backend,
                                     batch_axes=batch_axes, fft_axes=fft_axes)
        plan = inv.plan
    else:
        n, nb = PC.n, PC.nb
        bdom = Domain((0,), (nb - 1,))
        cube = Domain((0, 0, 0), (n - 1, n - 1, n - 1))
        bspec = "{%s}" % ",".join(str(a) for a in batch_axes)
        fspec = "{%s}" % ",".join(str(a) for a in fft_axes)
        ti = DistTensor.create((bdom, cube), f"b{bspec} x{fspec} y z", grid)
        to = DistTensor.create((bdom, cube), f"B{bspec} X Y Z{fspec}", grid)
        plan = FftPlan(ti, to, [("x", "X"), ("y", "Y"), ("z", "Z")],
                       inverse=True, backend=backend)
    stages = _stage_walk(plan)
    comm = plan.comm_stats()
    a2a = sum(8 * s["in"] for s in stages if "lines" not in s)
    coll = {c: 0 for c in _COLL}
    coll["all-to-all"] = a2a
    rec = {
        "arch": f"fftb-paper-{variant}",
        "shape": f"n{PC.n}-d{PC.diameter}-b{PC.nb}",
        "mesh": _mesh_name(grid), "n_devices": grid.nprocs,
        "flops": float(sum(dft_flops(s["n_out"], s["n_in"], s["lines"],
                                     s["backend"])
                           for s in stages if "lines" in s)),
        "bytes_accessed": float(sum(8 * (s["in"] + s["out"])
                                    for s in stages)),
        "collective_bytes": coll, "collective_total": float(a2a),
        "collective_model": "plan moves",
        "model_comm_bytes": comm,
        "mem": {"input": 8 * stages[0]["in"], "output": 8 * stages[-1]["out"],
                "largest_stage": max(8 * (s["in"] + s["out"])
                                     for s in stages)},
        "peak_bytes_per_device": max(8 * (s["in"] + s["out"])
                                     for s in stages),
        "stages": [s["stage"] for s in stages],
        "t_lower_s": time.perf_counter() - t0,
        "plan": plan.describe(),
    }
    if verbose:
        print(f"[{rec['mesh']}] {rec['arch']}: flops={rec['flops']:.3e} "
              f"coll={rec['collective_total']:.3e} "
              f"peak={rec['peak_bytes_per_device'] / 2**30:.2f}GiB",
              flush=True)
    return rec


# ------------------------------------------------------------------ main
def _load():
    try:
        with open(RESULTS) as f:
            return json.load(f)
    except FileNotFoundError:
        return {}


def _store(db):
    os.makedirs(os.path.dirname(RESULTS), exist_ok=True)
    tmp = RESULTS + ".tmp"
    with open(tmp, "w") as f:
        json.dump(db, f, indent=1)
    os.replace(tmp, RESULTS)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--paper", action="store_true")
    ap.add_argument("--paper-variant", default="planewave",
                    choices=["planewave", "padded"])
    ap.add_argument("--account", action="store_true",
                    help="L=1/L=2 extrapolated accounting pass")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    grids = []
    if args.mesh in ("single", "both"):
        grids.append(("single", make_abstract_production_grid()))
    if args.mesh in ("multi", "both"):
        grids.append(("multi", make_abstract_production_grid(multi_pod=True)))

    db = _load()
    failures = []
    passes: dict = {}        # counted passes, shared by the grids

    def run(arch, shape_name, gname, grid):
        key = f"{arch}|{shape_name}|{gname}"
        if args.account:
            key += "|acct"
        ok, why = applicable(get_config(arch), SHAPES[shape_name])
        if not ok:
            db[key] = {"arch": arch, "shape": shape_name, "mesh": gname,
                       "skipped": why}
            _store(db)
            print(f"SKIP {key}: {why}")
            return
        if key in db and not db[key].get("error") and not args.force:
            print(f"cached {key}")
            return
        try:
            fn = account_cell if args.account else lower_cell
            db[key] = fn(arch, shape_name, grid, passes=passes)
        except Exception as e:  # record the failure, keep sweeping
            db[key] = {"arch": arch, "shape": shape_name, "mesh": gname,
                       "error": f"{type(e).__name__}: {e}"}
            failures.append(key)
            print(f"FAIL {key}: {e}", flush=True)
        _store(db)

    if args.paper:
        for gname, grid in grids:
            key = f"fftb-paper-{args.paper_variant}|{gname}"
            if key in db and not db[key].get("error") and not args.force:
                print(f"cached {key}")
                continue
            db[key] = lower_paper_workload(grid, variant=args.paper_variant)
            _store(db)
        return 0

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    for arch in archs:
        for shape_name in shapes:
            for gname, grid in grids:
                run(arch, shape_name, gname, grid)
    if failures:
        print(f"\n{len(failures)} failures: {failures}")
        raise SystemExit(1)
    print("\nall cells OK")
    return 0


if __name__ == "__main__":
    main()
