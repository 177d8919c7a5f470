"""Tensor parallelism over "model" for the SSM, RG-LRU and encoder-decoder
families: the port's train step on placed weights over CPU processes
(gloo), against the reference's placed step on the same meshes.

Reduced Mamba-2 370M, RecurrentGemma-9B (one (rec, rec, attn) period)
and Whisper-small, float32, remat "none", on the reference's
``PRNGKey(0)`` weights (carried over by ``params_from_numpy``); Whisper's
frames drawn by numpy.  Each grid is spawned once (``run_ranks`` at the
lowest CPU priority, a ``file://`` rendezvous in ``tmp_path``) and runs
every case; the reference makes the weights and runs its train step in
the ``dist`` fixture's subprocesses (one a family, side by side), on 8
forced host devices (the 2×2 meshes on the first 4).

* Each family's 3 placed steps on 2×2 and on (2, 2, 2) against the
  reference's placed step on the same mesh (``device_put`` by
  ``param_shardings``): loss and grad_norm within 1e-6 relative at each
  step, the gathered parameters within 1e-5 of their largest.
* Against one process on the whole batch (rank 0 runs it): the first
  step's gradient (as its first moment) within ``GRAD_TOL`` of its
  largest.
* ``place_params``: every block equals ``ckpt/checkpoint.py::_block`` of
  the whole tensor under its spec, the specs are the reference's
  (``in_proj``/``w_x``/``w_r`` ("fsdp", "model"), ``out_proj``/``w_out``
  ("model", "fsdp"), ``conv_w`` (None, "model"), the SSD vectors
  replicated), and ``gather_params`` is their bitwise inverse.
* The operand bytes that ``core/grid.py::COLLECTIVE_BYTES`` counts per
  step equal :func:`_expected_bytes`, PERF.md §5's arithmetic, to the
  byte.
* ``tp.sum_over_model`` and ``tp.whole_over_model`` against the
  one-process ops, forward and backward; the gated RMSNorm's statistic
  summed by ``reduce_from_model`` (identity backward) instead gives
  another gradient.
* The ``Trainer`` on 2×2 places Mamba-2, checkpoints whole tensors and
  restores each rank's blocks bitwise; the launcher with ``--arch
  mamba2-370m --grid 2x2`` trains placed and the loss of a memorised
  batch falls.

The module imports no JAX: the ranks import it to find their functions;
the reference runs in the ``dist`` fixture's subprocess.
"""
import dataclasses
import os

import numpy as np
import pytest

FAMILIES = ("mamba2-370m", "recurrentgemma-9b", "whisper-small")
B, S, STEPS = 8, 16, 3
OPT = dict(lr=1e-4, warmup_steps=1, total_steps=10)
TIMEOUT = 240
#: the first step's gradient (as its first moment) against one process,
#: of its largest magnitude: the vocab-parallel embedding's gradient
#: gathers every position's hidden-state gradient, summed over "model" in
#: another order (measured up to 2.3e-6 there, every other leaf at most
#: 3e-7)
GRAD_TOL = 5e-6
GRID4 = ((2, 2), ("data", "model"))
GRID8 = ((2, 2, 2), ("pod", "data", "model"))
GRIDS = {"2x2": GRID4, "2x2x2": GRID8}
CASES = [(f, g) for f in FAMILIES for g in GRIDS]


def _spawn(fn, nprocs, **kw):
    from repro_torch.sharding.procs import run_ranks
    return run_ranks(fn, nprocs, nice=19, timeout=TIMEOUT, **kw)


def _cfg(arch, **kw):
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(arch).reduced(), **kw)


def _batch(cfg):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    out = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def _tensors(batch):
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _unflatten(flat) -> dict:
    tree = {}
    for name, v in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _load(path):
    return _unflatten(dict(np.load(path)))


def _axes(grid_axes):
    return tuple(a for a in grid_axes if a != "model")


def _rows(grid, axes):
    shard, n = 0, 1
    for a in axes:
        i = grid.axis_index(a)
        shard = shard * grid.shape[i] + grid.coordinate[i]
        n *= grid.shape[i]
    return slice(shard * B // n, (shard + 1) * B // n)


# ------------------------------------------------------------ rank cases
def _run(model, step, batch, counted=None):
    """STEPS steps: (losses, grad norms, the whole parameters after them,
    the whole first moment after the first step), numpy trees; with
    ``counted`` each step's collective bytes are appended."""
    from repro_torch.core.grid import collective_bytes
    from repro_torch.models.model_zoo import state_to_numpy
    from repro_torch.sharding import rules
    from repro_torch.train.train_step import init_opt_state
    opt = init_opt_state(model)
    losses, norms, first = [], [], None

    def whole(named):
        if rules.placement_of(model) is None:
            return named
        return rules.gather_named(model, named)
    tb = _tensors(batch)
    for _ in range(STEPS):
        collective_bytes(reset=True)
        model, opt, met = step(model, opt, tb)
        if counted is not None:
            counted.append(collective_bytes())
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        if first is None:
            first = state_to_numpy(model, {"m": whole(opt["m"])})["m"]
    params = whole({n: p.detach() for n, p in model.named_parameters()})
    return losses, norms, state_to_numpy(model, {"p": params})["p"], first


def _case(rank, grid, arch, weights):
    """The placed run of ``arch`` on ``grid`` with its counted bytes per
    step, and on rank 0 one process's run on the whole batch."""
    from repro_torch.models.model_zoo import build, params_from_numpy
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import ctx, rules
    from repro_torch.train.train_step import make_train_step
    cfg = _cfg(arch)
    bundle = build(cfg, device="cpu")
    full = _batch(cfg)
    ocfg = AdamWConfig(**OPT)
    batch_axes = _axes(grid.axes)
    counted = []
    with ctx.use(grid, batch_axes):
        model = params_from_numpy(cfg, weights, device="cpu")
        rules.place_params(model, grid)
        step = make_train_step(bundle, ocfg, grid)
        rows = _rows(grid, batch_axes)
        got = _run(model, step, {k: v[rows] for k, v in full.items()},
                   counted)
    out = {"got": got, "counted": counted}
    if rank == 0:
        whole = params_from_numpy(cfg, weights, device="cpu")
        out["want"] = _run(whole, make_train_step(bundle, ocfg), full)
    return out


def _placement(grid, arch, weights):
    """Each placed parameter against ``_block`` of the whole under its
    spec, the specs, and whether ``gather_params`` gives the whole back
    bitwise."""
    import torch
    from repro_torch.ckpt.checkpoint import _block
    from repro_torch.models.model_zoo import params_from_numpy
    from repro_torch.sharding import ctx, rules
    cfg = _cfg(arch)
    model = params_from_numpy(cfg, weights, device="cpu")
    whole = {n: p.detach().clone() for n, p in model.named_parameters()}
    with ctx.use(grid, _axes(grid.axes)):
        pl = rules.place_params(model, grid)
        back = rules.gather_params(model)
    bad = [n for n, p in model.named_parameters() if not torch.equal(
        p.detach(), whole[n][_block(pl.shapes[n], pl.specs[n], grid)])]
    return {"bad_blocks": bad, "specs": dict(pl.specs),
            "whole_back": all(torch.equal(back[n], whole[n])
                              for n in whole)}


def _tp_functions(rank, grid):
    """``sum_over_model`` and ``whole_over_model`` forward and backward on
    this rank's inputs, the one-process values they must equal, and the
    gated RMSNorm's input gradient with its statistic summed by
    ``reduce_from_model`` instead."""
    import torch
    from repro_torch.models import ssm
    from repro_torch.models.layers import rms_norm
    from repro_torch.sharding import ctx, tp
    world = grid.nprocs
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((world, 3, 5)).astype(np.float32)
    gs = rng.standard_normal((world, 3, 5)).astype(np.float32)
    m = grid.coordinate[grid.axis_index("model")]
    peers = [r for r in range(world) if r // 2 == rank // 2]
    out = {}
    with ctx.use(grid, ("data",)):
        x = torch.from_numpy(xs[rank]).requires_grad_()
        y = tp.sum_over_model(x)
        y.backward(torch.from_numpy(gs[rank]))
        out["sum_fwd"] = (y.detach().numpy(), xs[peers].sum(0))
        out["sum_grad"] = (x.grad.numpy(), gs[peers].sum(0))

        # a weight split over "model" by columns, and a replicated one
        w = rng.integers(-8, 8, (4, 6)).astype(np.float32)
        up = rng.integers(-8, 8, (world, 4, 6)).astype(np.float32)
        mod = torch.nn.Module()
        mod.w = torch.nn.Parameter(torch.from_numpy(w[:, 3 * m:3 * m + 3]))
        mod.r = torch.nn.Parameter(torch.from_numpy(w.copy()))
        mod.__dict__["_tp_specs"] = {"w": ((), ("model",))}
        y = tp.whole_over_model(mod, "w", 1)
        y.backward(torch.from_numpy(up[rank]))
        out["whole_gather"] = (y.detach().numpy(), w)
        out["whole_gather_grad"] = (mod.w.grad.numpy(),
                                    up[peers].sum(0)[:, 3 * m:3 * m + 3])
        y = tp.whole_over_model(mod, "r", 1)
        y.backward(torch.from_numpy(up[rank]))
        out["whole_copy"] = (y.detach().numpy(), w)
        out["whole_copy_grad"] = (mod.r.grad.numpy(), up[peers].sum(0))

        # the gated RMSNorm over a feature dim of 8, 4 a model rank
        feat = rng.standard_normal((3, 8)).astype(np.float32)
        seed = rng.standard_normal((3, 8)).astype(np.float32)
        sl = slice(4 * m, 4 * m + 4)
        zero = torch.zeros(8)

        def norm_grad(total):
            f = torch.from_numpy(feat[:, sl].copy()).requires_grad_()
            var = total(torch.sum(torch.square(f), -1, keepdim=True)) / 8
            y = f * torch.rsqrt(var + 1e-6)
            y.backward(torch.from_numpy(seed[:, sl].copy()))
            return f.grad.numpy()
        f = torch.from_numpy(feat).requires_grad_()
        rms_norm(f, zero).backward(torch.from_numpy(seed))
        want = f.grad.numpy()[:, sl]
        f = torch.from_numpy(feat[:, sl].copy()).requires_grad_()
        ssm._rms_norm_tp(f, zero[sl], 8, 1e-6).backward(
            torch.from_numpy(seed[:, sl].copy()))
        out["norm_grad"] = (f.grad.numpy(), want)
        out["norm_grad_reduce"] = (norm_grad(tp.reduce_from_model), want)
    return out


def _trainer_case(grid, ckpt_dir):
    """The Trainer on 2×2 with Mamba-2: 2 steps, a checkpoint of whole
    tensors, a second Trainer restoring each rank's blocks."""
    import torch
    import torch.distributed as dist
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model_zoo import build, reference_name, \
        stacked_lists
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import ctx, rules
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = _cfg("mamba2-370m")
    bundle = build(cfg, device="cpu")
    dcfg = DataConfig(vocab=cfg.vocab, seq=S, global_batch=B)

    def trainer(steps):
        return Trainer(bundle, AdamWConfig(**OPT), TrainerConfig(
            total_steps=steps, ckpt_every=1000, log_every=1000,
            ckpt_dir=ckpt_dir), dcfg, grid=grid)
    out = {}
    with ctx.use(grid, ("data",)):
        tr = trainer(2)
        params, opt = tr.run()
        whole = rules.gather_params(params)
        mine = {n: p.detach().clone() for n, p in params.named_parameters()}
        mine_v = {n: t.clone() for n, t in opt["v"].items()}
        out["placed"] = tr.placed
        out["in_proj"] = (tuple(params.layers[0].ssm.in_proj.shape),
                          rules.placement_of(params).shapes[
                              "layers.0.ssm.in_proj"])
        dist.barrier()
        if tr.writer:
            _, tree = CheckpointManager(ckpt_dir).restore()
            lists = stacked_lists(params)
            ok = True
            for n in whole:
                ref, idx = reference_name(n, lists)
                leaf = tree["params"]
                for k in ref.split("."):
                    leaf = leaf[k]
                ok &= torch.equal(leaf if idx is None else leaf[idx],
                                  whole[n])
            out["ckpt_whole"] = ok
        dist.barrier()
        tr2 = trainer(3)
        start, p2, o2 = tr2._restore_or_init(None)
        out["restored_step"] = start
        out["restored_blocks"] = all(
            torch.equal(p.detach(), mine[n])
            for n, p in p2.named_parameters()) and all(
            torch.equal(o2["v"][n], mine_v[n]) for n in mine_v)
    return out


def _four_ranks(rank, weights, ckpt_dir):
    from repro_torch.core.grid import ProcGrid
    grid = ProcGrid.create(*GRID4, device="cpu")
    out = {"tp": _tp_functions(rank, grid)}
    for arch in FAMILIES:
        w = _load(weights[arch])
        out[arch] = {"placement": _placement(grid, arch, w),
                     **_case(rank, grid, arch, w)}
    out["trainer"] = _trainer_case(grid, os.path.join(ckpt_dir, "trainer"))
    from repro_torch.launch.train import main
    tr = main(["--arch", "mamba2-370m", "--preset", "cpu-ci", "--grid",
               "2x2", "--steps", "4", "--seq", str(S), "--fixed-batch",
               "--ckpt-dir", os.path.join(ckpt_dir, "launcher"),
               "--device", "cpu"])
    out["launcher"] = {"placed": tr.placed,
                       "losses": [h["loss"] for h in tr.history]}
    return out


def _eight_ranks(rank, weights):
    from repro_torch.core.grid import ProcGrid
    grid = ProcGrid.create(*GRID8, device="cpu")
    out = {}
    for arch in FAMILIES:
        w = _load(weights[arch])
        out[arch] = {"placement": _placement(grid, arch, w),
                     **_case(rank, grid, arch, w)}
    return out


# --------------------------------------------------------- the arithmetic
def _expected_bytes(cfg, grid_shape, axes) -> dict:
    """Operand bytes per step and rank of the placed step of one of the
    three families (remat "none", float32, one microbatch, ``B`` × ``S``
    tokens): PERF.md §5's arithmetic.  Pd: the batch axes' processes, M:
    the model axis', T (Te): a rank's decoder (encoder) tokens, a = 4."""
    shape = dict(zip(axes, grid_shape))
    M = shape["model"]
    Pd = int(np.prod([shape[a] for a in axes if a != "model"]))
    D, V, F, K, a = cfg.d_model, cfg.vocab, cfg.d_ff, cfg.conv_kernel, 4
    H, Kh, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    T = B // Pd * S
    Te = B // Pd * cfg.enc_seq
    split = Pd * M                    # a 2-D weight's blocks
    fsdp = tp_ag = tp_rs = tp_ar = 0
    flat = D                          # ln_f, then each unsplit leaf
    groups = 1                        # {batch axes, "model"}
    # the vocab-parallel embedding and head (V divides by M here); the
    # loss's max, sum of exponentials and gold logit, in the forward and
    # in its chunk's recompute
    heads = 1 if cfg.tie_embeddings else 2
    fsdp += heads * V * D // split * a
    tp_ar += 2 * T * D * a + 2 * 3 * T * 4

    def attention(tokens, kv_gathered):
        """One attention sublayer's FSDP gathers and "model" reduces
        (``copy_to_model``'s backward, ``wo``'s sum); with
        ``kv_gathered`` ``wk``/``wv`` gathered whole over "model"."""
        ag = (2 * D * H * hd + 2 * D * Kh * hd) // split * a
        g = 2 * D * Kh * hd // M * a if kv_gathered else 0
        return ag, g, 2 * tokens * D * a

    def mlp(tokens):
        return 3 * D * F // split * a, 2 * tokens * D * a

    if cfg.family == "ssm":
        din, N, Hs = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
        C, Cc = 2 * din + 2 * N + Hs, din + 2 * N
        L = cfg.n_layers
        fsdp += L * (D * C + din * D) // split * a
        # in_proj and conv_w gathered whole over "model" (backward:
        # reduce-scatter of the whole)
        tp_ag += L * (D * C + K * Cc) // M * a
        tp_rs += L * (D * C + K * Cc) * a
        # copy_to_model(x)'s backward and out_proj's sum; the norm's sum
        # of squares forward and backward; the four float32 vectors'
        # copy_to_model backward
        tp_ar += L * (2 * T * D * a + 2 * T * 4 + (3 * Hs + din) * 4)
        flat += L * (D + K * Cc // M + 3 * Hs + din)
        groups += 1                   # conv_w: {"model"}
    elif cfg.family == "hybrid":
        R = cfg.d_rnn
        assert cfg.n_layers == len(cfg.block_pattern) == 3
        for _ in range(2):            # rec1, rec2
            fsdp += (3 * D * R + 2 * R * R) // split * a
            tp_ag += T * R // M * a   # u gathered for the gates
            tp_rs += T * R * a
            tp_ar += 2 * T * D * a + R * 4
            ag, ar = mlp(T)
            fsdp, tp_ar = fsdp + ag, tp_ar + ar
            flat += 2 * D + K * R // M + R
        ag, g, ar = attention(T, Kh % M != 0)
        fsdp, tp_ag, tp_rs, tp_ar = fsdp + ag, tp_ag + g, tp_rs + g * M, \
            tp_ar + ar
        ag, ar = mlp(T)
        fsdp, tp_ar = fsdp + ag, tp_ar + ar
        flat += 2 * D
        groups += 1                   # conv_w: {"model"}
    else:                             # encdec
        for tokens, n in ((Te, cfg.enc_layers), (T, cfg.n_layers)):
            ag, _, ar = attention(tokens, False)
            ag2, ar2 = mlp(tokens)
            fsdp += n * (ag + ag2)
            tp_ar += n * (ar + ar2)
            flat += n * 2 * D
        ag, _, ar = attention(T, False)   # the cross-attention
        fsdp += cfg.n_layers * ag
        tp_ar += cfg.n_layers * ar + Te * D * a   # + enc's copy_to_model
        flat += cfg.n_layers * D + D      # each cross ln, ln_enc
    return {"all-gather": fsdp + tp_ag,
            "reduce-scatter": fsdp * Pd + tp_rs,
            "all-reduce": 4 * flat + 4 + 4 * groups + tp_ar,
            "all-to-all": 0}


# ------------------------------------------------------------- fixtures
_REF = """
import os; os.nice(19)  # the lowest CPU priority, as the ranks'
import numpy as np, jax, jax.numpy as jnp
from repro.core.compat import mesh_from_devices
from repro.configs.base import get_config
from repro.models.model_zoo import build
from repro.optim.adamw import AdamWConfig
from repro.sharding import ctx, rules
from repro.train.train_step import init_opt_state, make_train_step
assert jax.device_count() == 8


def flat(tree):
    return {{"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}}


for arch, weights, batch_path, runs in {jobs!r}:
    cfg = get_config(arch).reduced()
    bundle = build(cfg)
    init = bundle.init(jax.random.PRNGKey(0))
    np.savez(weights, **flat(init))
    d = np.load(batch_path)
    batch = {{k: jnp.asarray(d[k]) for k in d.files}}
    for shape, axes, out in runs:
        devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
        mesh = mesh_from_devices(devs, axes)
        with ctx.use(mesh, tuple(a for a in axes if a != "model")):
            params = jax.device_put(init, rules.param_shardings(init, mesh))
            opt = init_opt_state(params)
            opt = jax.device_put(opt, rules.param_shardings(opt, mesh))
            step = make_train_step(bundle, AdamWConfig(**{opt!r}), mesh,
                                   donate=False)
            losses, norms = [], []
            for _ in range({steps}):
                params, opt, met = step(params, opt, batch)
                losses.append(float(met["loss"]))
                norms.append(float(met["grad_norm"]))
        np.savez(out, losses=np.asarray(losses), norms=np.asarray(norms),
                 **{{"p/" + k: v for k, v in flat(params).items()}})
print("OK")
"""


@pytest.fixture(scope="module")
def run_reference(dist, tmp_path_factory):
    """The reference's ``PRNGKey(0)`` weights of each family (saved
    flat) and its placed steps on both meshes: ({arch: weights file},
    {(arch, grid): (losses, norms, parameters)})."""
    from concurrent.futures import ThreadPoolExecutor
    d = tmp_path_factory.mktemp("ref")
    scripts, weights = [], {}
    for arch in FAMILIES:
        batch = str(d / f"{arch}-batch.npz")
        np.savez(batch, **_batch(_cfg(arch)))
        weights[arch] = str(d / f"{arch}-weights.npz")
        jobs = [(arch, weights[arch], batch, [
            (GRIDS[g][0], GRIDS[g][1], str(d / f"{arch}-{g}.npz"))
            for g in GRIDS])]
        scripts.append(_REF.format(jobs=jobs, opt=OPT, steps=STEPS))
    # one subprocess a family, side by side (each mostly compiles)
    with ThreadPoolExecutor(len(scripts)) as pool:
        outs = list(pool.map(lambda s: dist(s, n_devices=8), scripts))
    assert all("OK" in o for o in outs)
    out = {}
    for arch, g in CASES:
        ref = np.load(str(d / f"{arch}-{g}.npz"))
        out[arch, g] = (list(ref["losses"]), list(ref["norms"]), _unflatten(
            {k[2:]: ref[k] for k in ref.files if k.startswith("p/")}))
    return weights, out


@pytest.fixture(scope="module")
def reference(run_reference):
    return run_reference[1]


@pytest.fixture(scope="module")
def four(run_reference, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    return _spawn(_four_ranks, 4, args=(run_reference[0], ckpt),
                  rendezvous_dir=str(tmp_path_factory.mktemp("rdv4")))


@pytest.fixture(scope="module")
def eight(run_reference, tmp_path_factory):
    return _spawn(_eight_ranks, 8, args=(run_reference[0],),
                  rendezvous_dir=str(tmp_path_factory.mktemp("rdv8")))


@pytest.fixture(scope="module")
def ranks(four, eight):
    return {"2x2": four, "2x2x2": eight}


def _tree_err(got, want) -> float:
    g, w = dict(_flat(got)), dict(_flat(want))
    assert set(g) == set(w)
    scale = max(float(np.abs(v).max()) for v in w.values())
    return max(float(np.abs(g[k] - w[k]).max()) for k in w) / scale


def _rel(a, b) -> float:
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("arch,grid", CASES)
def test_tp_steps_match_the_reference_mesh(arch, grid, ranks, reference):
    want = reference[arch, grid]
    for rank in ranks[grid]:
        got = rank[arch]["got"]
        assert _rel(got[0], want[0]) <= 1e-6, (got[0], want[0])
        assert _rel(got[1], want[1]) <= 1e-6, (got[1], want[1])
        assert _tree_err(got[2], want[2]) <= 1e-5


@pytest.mark.parametrize("arch,grid", CASES)
def test_tp_first_step_gradient_equals_one_process(arch, grid, ranks):
    case = ranks[grid][0][arch]
    got, want = case["got"], case["want"]
    assert _rel(got[0], want[0]) <= 1e-6, (got[0], want[0])
    assert _rel(got[1], want[1]) <= 1e-6, (got[1], want[1])
    assert _tree_err(got[3], want[3]) <= GRAD_TOL
    assert _tree_err(got[2], want[2]) <= 1e-5


@pytest.mark.parametrize("arch,grid", CASES)
def test_place_params_blocks_and_gather(arch, grid, ranks):
    fsdp = ("pod", "data") if grid == "2x2x2" else ("data",)
    for rank in ranks[grid]:
        case = rank[arch]["placement"]
        assert case["bad_blocks"] == []
        assert case["whole_back"]
    specs = ranks[grid][0][arch]["placement"]["specs"]
    assert specs["embed"] == (("model",), fsdp)
    if arch == "mamba2-370m":
        assert specs["layers.0.ssm.in_proj"] == (fsdp, ("model",))
        assert specs["layers.0.ssm.out_proj"] == (("model",), fsdp)
        assert specs["layers.1.ssm.conv_w"] == ((), ("model",))
        for n in ("A_log", "D_skip", "dt_bias", "norm_scale"):
            assert specs[f"layers.0.ssm.{n}"] == ((),)
    elif arch == "recurrentgemma-9b":
        rec = "groups.0.rec2.rglru."
        for n in ("w_x", "w_gate_in", "w_r", "w_i"):
            assert specs[rec + n] == (fsdp, ("model",))
        assert specs[rec + "w_out"] == (("model",), fsdp)
        assert specs[rec + "conv_w"] == ((), ("model",))
        assert specs[rec + "lam"] == ((),)
        assert specs["groups.0.attn.wk"] == (fsdp, ("model",))
    else:
        for n in ("wq", "wk", "wv"):
            assert specs[f"enc_layers.1.{n}"] == (fsdp, ("model",))
            assert specs[f"cross.0.{n}"] == (fsdp, ("model",))
        assert specs["cross.1.wo"] == (("model",), fsdp)


@pytest.mark.parametrize("arch,grid", CASES)
def test_counted_collective_bytes_equal_the_arithmetic(arch, grid, ranks):
    want = _expected_bytes(_cfg(arch), *GRIDS[grid])
    for rank in ranks[grid]:
        for counted in rank[arch]["counted"]:
            assert counted == want, (counted, want)


@pytest.mark.parametrize("case", ["sum_fwd", "sum_grad", "whole_gather",
                                  "whole_gather_grad", "whole_copy",
                                  "whole_copy_grad", "norm_grad"])
def test_tp_functions_match_one_process(case, four):
    for rank in four:
        got, want = rank["tp"][case]
        if case.startswith("whole"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 *
                                       np.abs(want).max())


def test_norm_statistic_needs_the_all_reduce_backward(four):
    """The trap the gated RMSNorm sets: its sum of squares summed by
    ``reduce_from_model`` (identity backward) leaves out the other model
    rank's share of each input's gradient."""
    for rank in four:
        got, want = rank["tp"]["norm_grad_reduce"]
        assert np.abs(got - want).max() > 1e-3 * np.abs(want).max()


def test_trainer_restores_mamba2_blocks(four):
    outs = [r["trainer"] for r in four]
    assert all(o["placed"] for o in outs)
    local, whole = outs[0]["in_proj"]
    assert local == (whole[0] // 2, whole[1] // 2)
    assert outs[0]["ckpt_whole"]
    assert all(o["restored_step"] == 2 and o["restored_blocks"]
               for o in outs)


def test_launcher_trains_mamba2_on_2x2(four):
    for rank in four:
        out = rank["launcher"]
        assert out["placed"]
        assert out["losses"] == four[0]["launcher"]["losses"]
        assert out["losses"][-1] < out["losses"][0], out["losses"]


def test_module_imports_no_jax():
    src = open(os.path.abspath(__file__)).read()
    head = src[:src.index("_REF = ")]
    assert "import jax" not in head
