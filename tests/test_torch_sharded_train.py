"""The port's train step on *placed* weights over CPU processes (gloo).

Each rank of a grid holds only its block of every parameter
(``repro_torch.sharding.rules.place_params``, the reference's
``device_put(params, param_shardings(params, mesh))``) and of the AdamW
moments: FSDP over the batch axes, tensor parallelism over "model"
(``repro_torch.sharding.tp``).  Each grid is spawned once
(``run_ranks``, a ``file://`` rendezvous in ``tmp_path``, every rank at
the lowest CPU priority) and runs every case; each rank also runs the
one-process counterparts itself.  Reduced configs, float32, the
reference's ``PRNGKey(0)`` weights (carried over by
``params_from_numpy``) unless a case says otherwise.

* ``sharding/tp.py``'s functions against the one-process ops on the 2×2
  grid: the gather and its backward reduce-scatter exactly (integer
  values, so the sums are exact), ``copy_to_model`` and
  ``reduce_from_model`` forward and backward within 1e-6.
* The vocab-parallel embedding and cross-entropy (loss, and the
  gradients of the hidden states and of ``lm_head``'s block) against
  the whole ones, 1e-6.
* ``place_params``: each block equals ``_block`` of the whole tensor under
  the reference spec, and ``gather_params`` returns the whole bitwise,
  for tinyllama, granite-3-2b at its published vocabulary of 49155 (which
  2 does not divide: ``embed`` stays whole over "model") and tinyllama
  with one KV head (Kh = 1: the "model" axis splits ``wk``'s columns
  inside a head, so the attention gathers ``wk``/``wv`` over it).
* 3 steps against one process on the whole batch: tinyllama on 2×2 and on
  (2, 2, 2), qwen3 (qk-norm) on 2×2, tinyllama with Kh = 1 on 2×2, and
  tinyllama with compression on 2×2 (below): every loss and grad_norm
  within 1e-6 relative, the first step's gradient (as its first moment) within
  1e-6 of its largest magnitude, the gathered parameters after 3 steps
  within 1e-5 of their largest.  At ``LR`` = 1e-4: Adam divides each
  gradient element by its own running RMS, so an element whose gradient
  is at Adam's eps (measured: 5e-9 against a largest of 7e-2) turns its
  float32 rounding into a parameter difference of a sizeable part of the
  learning rate; at lr 1e-3 tinyllama on 2×2 measured 2.6e-5 of the
  largest parameter after one step (the first moments within 6e-7).
  With compression the int8 codes of a block equal the slices of one
  process's codes on the same gradient (a case of its own), and in the
  steps the first step's codes equal one process's; a later step's
  gradient differs by float32 rounding, so a code whose value sits at a
  rounding boundary may flip (ROADMAP §3 item 13; measured 0, 1 and 2
  flips in the 3 steps, at most ``FLIPS_MAX`` allowed): that step's
  grad_norm is held within 1e-6 relative plus the flipped elements'
  quantisation steps (|‖a‖ − ‖b‖| ≤ ‖a − b‖).
* The reference's ``test_distributed_train_step_runs`` on a placed
  (2, 2, 2) grid (2 microbatches, a memorised batch): the loss falls.
* Against the reference's own placed step: the ``dist`` fixture's 8
  forced host devices, the (2, 2, 2) mesh, weights and optimizer state
  ``device_put`` by ``param_shardings``, from the same weights: loss and
  grad_norm within 1e-5 relative at each of 3 steps, parameters within
  1e-4 of their largest.
* The ``Trainer`` on 2×2 places the weights: its losses equal one
  process's ``Trainer`` within 1e-6, its checkpoint holds whole tensors
  (equal to the gathered ones), and a second ``Trainer`` resumes from it
  with each rank's blocks restored bitwise.
* The launcher with ``--grid 2x2`` on the 4 ranks trains placed: the
  loss of a memorised batch falls.
* Over the batch axes alone (FSDP, a (4, 1) grid) every other family
  trains placed and agrees with one process at the limits above (MoE at
  its published capacity factor, SSM, hybrid, encoder-decoder, VLM;
  weights drawn by torch, the stub frontends' inputs from numpy), and
  the VLM, a dense decoder, also on 2×2 (the MoE's experts over "model":
  ``test_torch_ep_train.py``; the SSM, hybrid and encoder-decoder
  families over "model": ``test_torch_tp_families.py``).  The one
  process routes the MoE as the grid does: under a one-point grid of
  the same axes, so per batch row (the reference's groups where the
  "model" axis divides the experts).

The module imports no JAX: the ranks import it to find their functions;
the reference runs in the ``dist`` fixture's subprocess.
"""
import dataclasses
import os

import numpy as np
import pytest

B, S, STEPS = 8, 16, 3
LR = 1e-4
OPT = dict(lr=LR, warmup_steps=1, total_steps=10)
TIMEOUT = 240
ARCHS = ("tinyllama-1.1b", "qwen3-32b")
GRID4 = ((2, 2), ("data", "model"))
GRID8 = ((2, 2, 2), ("pod", "data", "model"))
#: int8 codes that may flip over the 3 compressed steps (measured 0, 1, 2)
FLIPS_MAX = 6
#: the families that train over the batch axes alone (FSDP), at their
#: published configs reduced
FSDP_FAMILIES = {"granite-moe-3b-a800m": {},
                 "mamba2-370m": {}, "recurrentgemma-9b": {},
                 "whisper-small": {}, "pixtral-12b": {}}


def _spawn(fn, nprocs, **kw):
    """``run_ranks`` at the lowest CPU priority (the ranks share the host
    with the rest of the test suite)."""
    from repro_torch.sharding.procs import run_ranks
    return run_ranks(fn, nprocs, nice=19, timeout=TIMEOUT, **kw)


def _batch(seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


def _unflatten(flat) -> dict:
    tree = {}
    for name, v in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _cfg(arch, **kw):
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(arch).reduced(), **kw)


def _rows(grid, axes):
    """This rank's rows of the batch: its coordinate over ``axes``."""
    shard, n = 0, 1
    for a in axes:
        i = grid.axis_index(a)
        shard = shard * grid.shape[i] + grid.coordinate[i]
        n *= grid.shape[i]
    return slice(shard * B // n, (shard + 1) * B // n)


def _tensors(batch):
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _run(model, step, batch, steps=STEPS, compress=False):
    """``steps`` steps: (losses, grad norms, the whole parameters after
    them, the whole first moment after the first step), the wholes as
    numpy trees (gathered on placed weights)."""
    from repro_torch.models.model_zoo import state_to_numpy
    from repro_torch.sharding import rules
    from repro_torch.train.train_step import init_opt_state
    opt = init_opt_state(model, compress=compress)
    losses, norms, first = [], [], None

    def whole(named):
        if rules.placement_of(model) is None:
            return named
        return rules.gather_named(model, named)
    tb = _tensors(batch)
    for _ in range(steps):
        model, opt, met = step(model, opt, tb)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        if first is None:
            first = state_to_numpy(model, {"m": whole(opt["m"])})["m"]
    params = whole({n: p.detach() for n, p in model.named_parameters()})
    return losses, norms, state_to_numpy(model, {"p": params})["p"], first


def _codes_spy(model, record):
    """Wrap ``train_step.compress_grads`` to append each step's whole int8
    codes and scales (gathered on placed weights) to ``record``; returns
    the function that removes the wrapper."""
    from repro_torch.sharding import rules
    from repro_torch.train import train_step
    real = train_step.compress_grads

    def spy(grads, residuals, placement=None):
        comp, res = real(grads, residuals, placement)
        codes = {n: q for n, (q, _) in comp.items()}
        if placement is not None:
            codes = rules.gather_named(model, codes)
        record.append({n: (q.numpy().copy(), float(comp[n][1]))
                       for n, q in codes.items()})
        return comp, res
    train_step.compress_grads = spy

    def remove():
        train_step.compress_grads = real
    return remove


def _placed_run(cfg, init, grid, batch_axes, steps=STEPS, compress=False,
                microbatches=1, opt=None, batch=None):
    """The placed run on ``grid`` and, in this process, one process's run
    on the whole batch from the same weights, under a one-point grid of
    ``grid``'s axes (an MoE then routes per batch row, as on ``grid``);
    with ``compress`` each run's codes per step come last."""
    from repro_torch.core.grid import ProcGrid
    from repro_torch.models.model_zoo import build, params_from_numpy
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import ctx, rules
    from repro_torch.train.train_step import make_train_step
    bundle = build(cfg, device="cpu")
    full = batch or _batch(vocab=cfg.vocab)
    ocfg = AdamWConfig(**(opt or OPT))
    codes = ([], [])
    with ctx.use(grid, batch_axes):
        model = params_from_numpy(cfg, init, device="cpu")
        rules.place_params(model, grid)
        step = make_train_step(bundle, ocfg, grid, compress=compress,
                               microbatches=microbatches)
        rows = _rows(grid, batch_axes)
        remove = _codes_spy(model, codes[0]) if compress else None
        try:
            got = _run(model, step, {k: v[rows] for k, v in full.items()},
                       steps, compress)
        finally:
            if remove:
                remove()
    one = make_train_step(bundle, ocfg, compress=compress,
                          microbatches=microbatches)
    whole = params_from_numpy(cfg, init, device="cpu")
    remove = _codes_spy(whole, codes[1]) if compress else None
    point = ProcGrid.create((1,) * grid.ndim, grid.axes, device="cpu")
    try:
        with ctx.use(point, None):
            want = _run(whole, one, full, steps, compress)
    finally:
        if remove:
            remove()
    if compress:
        return got + (codes[0],), want + (codes[1],)
    return got, want


def _load(path):
    return _unflatten(dict(np.load(path)))


# ------------------------------------------------------------ rank cases
def _tp_functions(rank, grid):
    """Each function's forward and backward on this rank's inputs, and
    the one-process values they must equal."""
    import torch
    from repro_torch.sharding import ctx, tp
    world = grid.nprocs
    rng = np.random.default_rng(7)
    whole = rng.integers(-8, 8, (4, 6)).astype(np.float32)
    ups = rng.integers(-8, 8, (world, 4, 6)).astype(np.float32)
    xs = rng.standard_normal((world, 3, 5)).astype(np.float32)
    gs = rng.standard_normal((world, 3, 5)).astype(np.float32)
    d, m = (grid.coordinate[grid.axis_index(a)] for a in ("data", "model"))
    blk = (slice(2 * d, 2 * d + 2), slice(3 * m, 3 * m + 3))
    model_peers = [r for r in range(world) if r // 2 == rank // 2]
    out = {}
    with ctx.use(grid, ("data",)):
        x = torch.from_numpy(whole[blk].copy()).requires_grad_()
        y = tp.gather(x, {0: ("data",), 1: ("model",)})
        y.backward(torch.from_numpy(ups[rank]))
        out["gather"] = (y.detach().numpy(), whole)
        out["gather_grad"] = (x.grad.numpy(), ups.sum(0)[blk])
        x = torch.from_numpy(xs[rank]).requires_grad_()
        y = tp.copy_to_model(x)
        y.backward(torch.from_numpy(gs[rank]))
        out["copy_fwd"] = (y.detach().numpy(), xs[rank])
        out["copy_grad"] = (x.grad.numpy(), gs[model_peers].sum(0))
        x = torch.from_numpy(xs[rank]).requires_grad_()
        y = tp.reduce_from_model(x)
        y.backward(torch.from_numpy(gs[rank]))
        out["reduce_fwd"] = (y.detach().numpy(), xs[model_peers].sum(0))
        out["reduce_grad"] = (x.grad.numpy(), gs[rank])
    return out


def _vocab_parallel(rank, grid, init):
    """The placed embedding lookup and cross-entropy, and their whole
    counterparts, with the gradients of h and of lm_head's block."""
    import torch
    from repro_torch.ckpt.checkpoint import _block
    from repro_torch.models import transformer
    from repro_torch.models.model_zoo import chunked_xent, params_from_numpy
    from repro_torch.sharding import ctx, rules, tp
    cfg = _cfg("tinyllama-1.1b")
    batch = _tensors(_batch())
    rng = np.random.default_rng(3)
    h0 = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                          .astype(np.float32))
    whole = params_from_numpy(cfg, init, device="cpu")
    placed = params_from_numpy(cfg, init, device="cpu")

    def run(model, head):
        h = h0.clone().requires_grad_()
        x = transformer._embed(model, batch["tokens"].long())
        loss = chunked_xent(model, h, batch["labels"].long(), cfg,
                            chunk=8)
        dh, dw = torch.autograd.grad(loss, [h, head])
        return x.detach().numpy(), float(loss), dh.numpy(), dw.numpy()
    want = run(whole, whole.lm_head)
    with ctx.use(grid, ("data",)):
        pl = rules.place_params(placed, grid)
        head = placed.lm_head                 # the parameter: its block
        with tp.gathered(placed, skip=("layers",)):
            got = run(placed, head)
    blk = _block(pl.shapes["lm_head"], pl.specs["lm_head"], grid)
    # every rank ran the whole batch: the gather's backward summed the
    # two data ranks' equal gradients
    return got[:3] + (got[3] / 2,), want[:3] + (want[3][blk],)


def _placement_cases(rank, grid):
    """(name, block, expected block) of every parameter of three models
    placed on ``grid``, and whether ``gather_params`` gave the whole back
    bitwise; the granite embedding's and tinyllama-Kh=1's specs."""
    import torch
    from repro_torch.ckpt.checkpoint import _block
    from repro_torch.models.model_zoo import build, reference_name, \
        stacked_lists
    from repro_torch.sharding import ctx, rules
    out = {}
    for key, cfg in (("tinyllama", _cfg("tinyllama-1.1b")),
                     ("granite", _cfg("granite-3-2b", vocab=49155)),
                     ("kv1", _cfg("tinyllama-1.1b", n_kv=1))):
        gen = torch.Generator().manual_seed(1)
        model = build(cfg, device="cpu").init(gen)
        whole = {n: p.detach().clone() for n, p in model.named_parameters()}
        ref = rules.param_specs(model, grid)
        lists = stacked_lists(model)
        with ctx.use(grid, ("data",)):
            pl = rules.place_params(model, grid)
            back = rules.gather_params(model, grid)
        bad = []
        for n, p in model.named_parameters():
            spec = ref[n][1:] if reference_name(n, lists)[1] is not None \
                else ref[n]
            want = whole[n][_block(tuple(whole[n].shape), spec, grid)]
            if not torch.equal(p.detach(), want):
                bad.append(n)
        out[key] = {"bad_blocks": bad,
                    "whole_back": all(torch.equal(back[n], whole[n])
                                      for n in whole),
                    "specs": pl.specs, "shapes": pl.shapes,
                    "local": {n: tuple(p.shape)
                              for n, p in model.named_parameters()}}
    return out


def _compression_codes(rank, grid):
    """compress_grads of this rank's blocks of one random gradient tree
    (placed) and of the whole tree: (block codes, sliced whole codes)."""
    import torch
    from repro_torch.ckpt.checkpoint import _block
    from repro_torch.optim.compression import compress_grads
    from repro_torch.sharding import ctx, rules
    from repro_torch.models.model_zoo import build
    cfg = _cfg("tinyllama-1.1b")
    gen = torch.Generator().manual_seed(2)
    model = build(cfg, device="cpu").init(gen)
    rng = np.random.default_rng(5)
    grads = {n: torch.from_numpy(rng.standard_normal(tuple(p.shape))
                                 .astype(np.float32))
             for n, p in model.named_parameters()}
    zeros = {n: torch.zeros_like(g) for n, g in grads.items()}
    whole, _ = compress_grads(grads, zeros)
    with ctx.use(grid, ("data",)):
        pl = rules.place_params(model, grid)
    blocks = {n: g[_block(pl.shapes[n], pl.specs[n], grid)]
              for n, g in grads.items()}
    got, _ = compress_grads(blocks, {n: torch.zeros_like(g) for n, g in
                                     blocks.items()}, pl)
    return {n: (bool(torch.equal(got[n][0], whole[n][0][
        _block(pl.shapes[n], pl.specs[n], grid)])),
        float(got[n][1]), float(whole[n][1])) for n in grads}


def _trainer_case(rank, grid, ckpt_dir):
    """The Trainer on the placed grid: 2 steps, a checkpoint, a resume to
    step 3 in a second Trainer; one process's Trainer on rank 0."""
    import torch
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model_zoo import build, reference_name, \
        stacked_lists
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import ctx, rules
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = _cfg("tinyllama-1.1b")
    bundle = build(cfg, device="cpu")
    dcfg = DataConfig(vocab=cfg.vocab, seq=S, global_batch=B)

    def trainer(root, g, steps):
        return Trainer(bundle, AdamWConfig(**OPT), TrainerConfig(
            total_steps=steps, ckpt_every=1000, log_every=1000,
            ckpt_dir=os.path.join(ckpt_dir, root)), dcfg, grid=g)
    out = {}
    with ctx.use(grid, ("data",)):
        tr = trainer("placed", grid, 2)
        params, opt = tr.run()
        whole = rules.gather_params(params)
        mine = {n: p.detach().clone() for n, p in params.named_parameters()}
        mine_m = {n: t.clone() for n, t in opt["m"].items()}
        out["placed"] = tr.placed and \
            rules.placement_of(params) is not None
        out["losses"] = [h["loss"] for h in tr.history]
        out["shard"] = (tr.pipeline.shard, tr.pipeline.n_shards)
        out["writer"] = tr.writer
        import torch.distributed as dist
        dist.barrier()
        if tr.writer:                 # the files hold the whole tensors
            step, tree = CheckpointManager(
                os.path.join(ckpt_dir, "placed")).restore()
            lists = stacked_lists(params)
            files = {}
            for n in whole:
                ref, idx = reference_name(n, lists)
                leaf = tree["params"]
                for k in ref.split("."):
                    leaf = leaf[k]
                files[n] = leaf if idx is None else leaf[idx]
            out["ckpt_step"] = step
            out["ckpt_whole"] = all(torch.equal(files[n], whole[n])
                                    for n in whole)
        dist.barrier()
        tr2 = trainer("placed", grid, 3)
        start, p2, o2 = tr2._restore_or_init(None)
        pl = rules.placement_of(p2)
        out["restored_step"] = start
        out["restored_blocks"] = all(
            torch.equal(p.detach(), mine[n])
            for n, p in p2.named_parameters()) and all(
            torch.equal(o2["m"][n], mine_m[n]) for n in mine_m)
        out["restored_local"] = all(
            tuple(p.shape) == tuple(mine[n].shape) != pl.shapes[n]
            for n, p in p2.named_parameters() if any(pl.specs[n]))
        tr2.run()
        out["resumed"] = [h["step"] for h in tr2.history]
    if rank == 0:
        one = trainer("one", None, 2)
        one.run()
        out["one"] = [h["loss"] for h in one.history]
    return out


def _family_run(cfg, grid, batch_axes):
    """:func:`_placed_run` of ``cfg`` from weights drawn by torch, on a
    batch with the family's stub frontend inputs."""
    import torch
    from repro_torch.models.model_zoo import build, state_to_numpy
    model = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = _batch(vocab=cfg.vocab)
    rng = np.random.default_rng(1)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return _placed_run(cfg, state_to_numpy(model), grid, batch_axes,
                       batch=batch)


def _families(grid):
    """Every family over the batch axes alone (FSDP) trains, against one
    process, and the VLM (a dense decoder with image embeddings) on
    2×2."""
    from repro_torch.core.grid import ProcGrid
    out = {}
    fsdp = ProcGrid.create((4, 1), ("data", "model"), device="cpu")
    for arch, kw in FSDP_FAMILIES.items():
        out[f"fsdp/{arch}"] = _family_run(_cfg(arch, **kw), fsdp,
                                          ("data",))
    out["vlm_2x2"] = _family_run(_cfg("pixtral-12b"), grid, ("data",))
    return out


def _four_ranks(rank, inits, ckpt_dir):
    from repro_torch.core.grid import ProcGrid
    grid = ProcGrid.create(*GRID4, device="cpu")
    tiny, qwen = _load(inits["tinyllama-1.1b"]), _load(inits["qwen3-32b"])
    out = {"tp": _tp_functions(rank, grid),
           "vocab": _vocab_parallel(rank, grid, tiny),
           "placement": _placement_cases(rank, grid),
           "codes": _compression_codes(rank, grid)}
    for key, cfg, init, compress in (
            ("tinyllama", _cfg("tinyllama-1.1b"), tiny, False),
            ("qwen3", _cfg("qwen3-32b"), qwen, False),
            ("compress", _cfg("tinyllama-1.1b"), tiny, True)):
        out[key] = _placed_run(cfg, init, grid, ("data",),
                               compress=compress)
    out["kv1"] = _placed_run(_cfg("tinyllama-1.1b", n_kv=1),
                             _load(inits["kv1"]), grid, ("data",))
    out["trainer"] = _trainer_case(rank, grid, ckpt_dir)
    from repro_torch.launch.train import main
    tr = main(["--preset", "cpu-ci", "--grid", "2x2", "--steps", "4",
               "--fixed-batch", "--ckpt-dir",
               os.path.join(ckpt_dir, "launcher"), "--device", "cpu"])
    out["launcher"] = {"placed": tr.placed,
                       "losses": [h["loss"] for h in tr.history]}
    out["families"] = _families(grid)
    return out


def _eight_ranks(rank, inits):
    from repro_torch.core.grid import ProcGrid
    grid = ProcGrid.create(*GRID8, device="cpu")
    tiny = _load(inits["tinyllama-1.1b"])
    cfg = _cfg("tinyllama-1.1b")
    out = {"tinyllama": _placed_run(cfg, tiny, grid, ("pod", "data"))}
    # the reference's test_distributed_train_step_runs: a memorised batch
    # of 8 x 32, 2 microbatches, no warmup
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
    mem = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    out["memorise"] = _memorise(grid, cfg, tiny, mem)
    # the reference's placed step's own run: OPT_REF, 3 steps
    out["reference_run"] = _placed_run(cfg, tiny, grid, ("pod", "data"),
                                       opt=OPT_REF)[0][:3]
    return out


def _memorise(grid, cfg, init, mem):
    from repro_torch.models.model_zoo import build, params_from_numpy
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import ctx, rules
    from repro_torch.train.train_step import init_opt_state, \
        make_train_step
    bundle = build(cfg, device="cpu")
    axes = ("pod", "data")
    with ctx.use(grid, axes):
        model = params_from_numpy(cfg, init, device="cpu")
        rules.place_params(model, grid)
        opt = init_opt_state(model)
        step = make_train_step(bundle, AdamWConfig(warmup_steps=0), grid,
                               microbatches=2)
        n = 4
        shard = grid.coordinate[0] * 2 + grid.coordinate[1]
        tb = _tensors({k: v[shard * 8 // n:(shard + 1) * 8 // n]
                       for k, v in mem.items()})
        losses = []
        for _ in range(3):
            model, opt, met = step(model, opt, tb)
            losses.append(float(met["loss"]))
    return losses


OPT_REF = dict(lr=1e-3, warmup_steps=1, total_steps=10)

_REF_INIT = """
import os; os.nice(19)  # the lowest CPU priority, as the ranks'
import dataclasses
import numpy as np, jax
from repro.configs.base import get_config
from repro.models.model_zoo import build
for arch, kw, out in {jobs!r}:
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    p = build(cfg).init(jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(p)[0]
    np.savez(out, **{{"/".join(k.key for k in path): np.asarray(v)
                     for path, v in flat}})
print("OK")
"""

_REF_STEP = """
import os; os.nice(19)
import numpy as np, jax, jax.numpy as jnp
from repro.core.compat import make_mesh
from repro.configs.base import get_config
from repro.models.model_zoo import build
from repro.optim.adamw import AdamWConfig
from repro.sharding import ctx, rules
from repro.train.train_step import init_opt_state, make_train_step
assert jax.device_count() == 8
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
cfg = get_config("tinyllama-1.1b").reduced()
bundle = build(cfg)
d = np.load({batch!r})
batch = {{k: jnp.asarray(d[k]) for k in ("tokens", "labels")}}
with ctx.use(mesh, ("pod", "data")):
    params = bundle.init(jax.random.PRNGKey(0))
    params = jax.device_put(params, rules.param_shardings(params, mesh))
    opt = init_opt_state(params)
    opt = jax.device_put(opt, rules.param_shardings(opt, mesh))
    step = make_train_step(bundle, AdamWConfig(**{opt!r}), mesh,
                           donate=False)
    losses, norms = [], []
    for _ in range({steps}):
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
flat = {{"/".join(k.key for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}}
np.savez({out!r}, losses=np.asarray(losses), norms=np.asarray(norms),
         **{{"p/" + k: v for k, v in flat.items()}})
print("OK")
"""


@pytest.fixture(scope="module")
def inits(dist, tmp_path_factory):
    d = tmp_path_factory.mktemp("init")
    jobs = [(a, {}, str(d / f"{a}.npz")) for a in ARCHS]
    jobs.append(("tinyllama-1.1b", {"n_kv": 1}, str(d / "kv1.npz")))
    assert "OK" in dist(_REF_INIT.format(jobs=jobs), n_devices=1)
    out = {a: p for a, _, p in jobs[:-1]}
    out["kv1"] = jobs[-1][2]
    return out


@pytest.fixture(scope="module")
def four(inits, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    return _spawn(_four_ranks, 4, args=(inits, ckpt),
                  rendezvous_dir=str(tmp_path_factory.mktemp("rdv4")))


@pytest.fixture(scope="module")
def eight(inits, tmp_path_factory):
    return _spawn(_eight_ranks, 8, args=(inits,),
                  rendezvous_dir=str(tmp_path_factory.mktemp("rdv8")))


@pytest.fixture(scope="module")
def reference(dist, tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    batch, out = str(d / "batch.npz"), str(d / "out.npz")
    np.savez(batch, **_batch())
    assert "OK" in dist(_REF_STEP.format(batch=batch, out=out, opt=OPT_REF,
                                         steps=STEPS), n_devices=8)
    ref = np.load(out)
    params = _unflatten({k[2:]: ref[k] for k in ref.files
                         if k.startswith("p/")})
    return list(ref["losses"]), list(ref["norms"]), params


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _tree_err(got, want) -> float:
    g, w = dict(_flat(got)), dict(_flat(want))
    assert set(g) == set(w)
    scale = max(float(np.abs(v).max()) for v in w.values())
    return max(float(np.abs(g[k] - w[k]).max()) for k in w) / scale


def _rel(a, b) -> float:
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def _agrees(got, want):
    assert _rel(got[0], want[0]) <= 1e-6, (got[0], want[0])
    assert _rel(got[1], want[1]) <= 1e-6, (got[1], want[1])
    assert _tree_err(got[3], want[3]) <= 1e-6
    assert _tree_err(got[2], want[2]) <= 1e-5


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("case", ["gather", "gather_grad", "copy_fwd",
                                  "copy_grad", "reduce_fwd", "reduce_grad"])
def test_tp_functions_match_one_process(case, four):
    for rank in four:
        got, want = rank["tp"][case]
        if case.startswith("gather") or case in ("copy_fwd", "reduce_grad"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 *
                                       np.abs(want).max())


def test_vocab_parallel_embedding_and_xent(four):
    for rank in four:
        got, want = rank["vocab"]
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=0)
        assert abs(got[1] - want[1]) <= 1e-6 * abs(want[1])
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("key", ["tinyllama", "granite", "kv1"])
def test_place_params_blocks_and_gather(key, four):
    for rank in four:
        case = rank["placement"][key]
        assert case["bad_blocks"] == []
        assert case["whole_back"]
    specs = four[0]["placement"][key]["specs"]
    local = four[0]["placement"][key]["local"]
    shapes = four[0]["placement"][key]["shapes"]
    assert specs["layers.0.wq"] == (("data",), ("model",))
    assert specs["layers.0.wo"] == (("model",), ("data",))
    assert specs["layers.0.ln1"] == ((),)
    assert local["layers.0.mlp.w_up"] == (shapes["layers.0.mlp.w_up"][0]
                                          // 2,
                                          shapes["layers.0.mlp.w_up"][1]
                                          // 2)
    if key == "granite":                 # 49155 does not split over 2
        assert specs["embed"] == ((), ("data",))
        assert local["embed"] == (49155, 32)
    else:
        assert specs["embed"] == (("model",), ("data",))
    if key == "kv1":                     # one head's 16 columns, split
        assert specs["layers.0.wk"] == (("data",), ("model",))
        assert local["layers.0.wk"] == (32, 8)


@pytest.mark.parametrize("key", ["tinyllama", "qwen3", "kv1"])
def test_placed_steps_equal_one_process_2x2(key, four):
    for rank in four:
        _agrees(*rank[key])
    assert all(r[key][0][0] == four[0][key][0][0] for r in four)


def test_placed_compressed_steps_equal_one_process_2x2(four):
    """The first step's codes are one process's; a later code may flip at
    a rounding boundary (ROADMAP §3 item 13), and its step's grad_norm
    may then move by at most the flipped elements' quantisation steps."""
    for rank in four:
        got, want = rank["compress"]
        flips, moved = [], []
        for a, b in zip(got[4], want[4]):
            diff = {n: a[n][0] != b[n][0] for n in a}
            flips.append(sum(int(d.sum()) for d in diff.values()))
            moved.append(np.sqrt(sum(int(d.sum()) * b[n][1] ** 2
                                     for n, d in diff.items())))
        assert flips[0] == 0
        assert sum(flips) <= FLIPS_MAX, flips
        assert _rel(got[0], want[0]) <= 1e-6
        for g, w, m in zip(got[1], want[1], moved):
            assert abs(g - w) <= 1e-6 * w + m, (got[1], want[1], flips)
        assert _tree_err(got[3], want[3]) <= 1e-6
        assert _tree_err(got[2], want[2]) <= 1e-5


def test_placed_steps_equal_one_process_2x2x2(eight):
    for rank in eight:
        _agrees(*rank["tinyllama"])


def test_compressed_codes_are_slices_of_one_process(four):
    for rank in four:
        for name, (equal, scale, whole) in rank["codes"].items():
            assert equal, name
            assert scale == whole, name


def test_distributed_train_step_runs_placed(eight):
    for rank in eight:
        losses = rank["memorise"]
        assert np.isfinite(losses[-1])
        assert losses[-1] < losses[0], losses


def test_placed_step_matches_the_reference_placed_mesh(eight, reference):
    losses, norms, params = reference
    got = eight[0]["reference_run"]
    assert _rel(got[0], losses) <= 1e-5
    assert _rel(got[1], norms) <= 1e-5
    assert _tree_err(got[2], params) <= 1e-4


def test_trainer_places_checkpoints_whole_and_restores_blocks(four):
    outs = [r["trainer"] for r in four]
    assert all(o["placed"] for o in outs)
    assert [o["shard"] for o in outs] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert [o["writer"] for o in outs] == [True, False, False, False]
    assert all(o["losses"] == outs[0]["losses"] for o in outs)
    assert _rel(outs[0]["losses"], outs[0]["one"]) <= 1e-6
    assert outs[0]["ckpt_step"] == 2 and outs[0]["ckpt_whole"]
    assert all(o["restored_step"] == 2 and o["restored_blocks"]
               and o["restored_local"] for o in outs)
    assert all(o["resumed"] == [2] for o in outs)


def test_launcher_trains_placed_on_a_grid(four):
    for rank in four:
        out = rank["launcher"]
        assert out["placed"]
        assert out["losses"] == four[0]["launcher"]["losses"]
        assert out["losses"][-1] < out["losses"][0], out["losses"]


@pytest.mark.parametrize("arch", list(FSDP_FAMILIES))
def test_every_family_over_the_batch_axes_alone(arch, four):
    for rank in four:
        _agrees(*rank["families"][f"fsdp/{arch}"])


def test_vlm_tensor_parallel_2x2(four):
    for rank in four:
        _agrees(*rank["families"]["vlm_2x2"])


def test_module_imports_no_jax():
    src = open(os.path.abspath(__file__)).read()
    head = src[:src.index("_REF_INIT")]
    assert "import jax" not in head.replace("import jax, ", "")
