"""Tensor parallelism over "model" when the axis does not split the heads
evenly: the port's train step on placed weights over CPU processes
(gloo), against the reference's placed step on the same meshes.

The reference trains such placements: ``rules.drop_indivisible`` splits
``wq`` by columns whenever M divides H·hd, off head boundaries, and
GSPMD reshards what the heads need.  The port gives rank r of M the
heads ``[r·H // M, (r+1)·H // M)`` (``sharding/tp.py::head_range``), takes
the attention weights (and Mamba-2's ``out_proj``) whole over "model"
and slices them; with H < M some ranks compute no heads and still join
every collective.  Reduced configs, float32, remat "none", on the
reference's ``PRNGKey(0)`` weights (carried over by
``params_from_numpy``), batches drawn by numpy:

* on (2, 2), more heads than ranks but not a multiple: Whisper-small with
  3 heads and 3 KV heads, Granite-MoE 3B-A800M with 3 heads and 1 KV
  head, the same with 3 experts (``granite-moe-h3-e3``: nor does 2
  divide the experts, so every model rank holds them all and the
  microbatch routes in one global group over the data ranks, the
  layout of the production grid's 16-way "model" axis, which divides
  none of Granite-MoE's 24 heads, 8 KV heads and 40 experts),
  RecurrentGemma-9B (one (rec, rec, attn) period) with 3 heads,
  Mamba-2 370M at d_model 24 (3 SSD heads);
* on (1, 8), fewer heads than ranks: Whisper-small's reduced config (4
  heads on 8 ranks: half the ranks compute none).

Each grid is spawned once (``run_ranks`` at the lowest CPU priority, a
``file://`` rendezvous in ``tmp_path``) and runs every case; the
reference makes the weights and runs its placed step in the ``dist``
fixture's subprocesses (one a case, side by side) on 8 forced host
devices (the 2×2 meshes on the first 4).

* 3 placed steps against the reference's: loss and grad_norm within 1e-6
  relative at each step, the gathered parameters within 1e-5 of their
  largest.
* Against one process on the whole batch (rank 0 runs it; the MoE routed
  per batch row, as on the grid): the first step's gradient (as its first
  moment) within ``GRAD_TOL`` of its largest.
* ``place_params`` keeps the reference's blocks (``wq`` split by columns
  off the heads), and ``gather_params`` is their bitwise inverse; the
  ranks' head ranges cover every head once.
* The operand bytes that ``core/grid.py::COLLECTIVE_BYTES`` counts per
  step equal ``chip_smoke.py::tp_counted_bytes`` (``ep_counted_bytes``
  for the MoE), whose ``attn_whole`` adds the weights taken whole,
  to the byte; on the grids where M divides the heads that arithmetic is
  the families' ``_expected_bytes`` of ``test_torch_tp_families.py`` and
  ``test_torch_ep_train.py``, unchanged.
* The launcher with ``--arch whisper-small --grid 1x8`` trains placed.

The module imports no JAX: the ranks import it to find their functions;
the reference runs in the ``dist`` fixture's subprocess.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
from test_torch_tp_families import STEPS, _load, _rel, _run, _tree_err, \
    _unflatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 8, 16
OPT = dict(lr=1e-4, warmup_steps=1, total_steps=10)
TIMEOUT = 240
#: the first step's gradient (as its first moment) against one process,
#: of its largest magnitude, as ``test_torch_tp_families.py``'s: the
#: vocab-parallel embedding's gradient sums over "model" in another order
GRAD_TOL = 5e-6
GRID4 = ((2, 2), ("data", "model"))
GRID8 = ((1, 8), ("data", "model"))
GRIDS = {"2x2": GRID4, "1x8": GRID8}
#: case → (arch, overrides of its reduced config, grid)
CASES = {
    "whisper-h3": ("whisper-small", {"n_heads": 3, "n_kv": 3}, "2x2"),
    "granite-moe-h3": ("granite-moe-3b-a800m", {"n_heads": 3, "n_kv": 1},
                       "2x2"),
    "granite-moe-h3-e3": ("granite-moe-3b-a800m",
                          {"n_heads": 3, "n_kv": 1, "n_experts": 3}, "2x2"),
    "recurrentgemma-h3": ("recurrentgemma-9b", {"n_heads": 3}, "2x2"),
    "mamba2-d24": ("mamba2-370m", {"d_model": 24}, "2x2"),
    "whisper-1x8": ("whisper-small", {}, "1x8"),
}


def _spawn(fn, nprocs, **kw):
    from repro_torch.sharding.procs import run_ranks
    return run_ranks(fn, nprocs, nice=19, timeout=TIMEOUT, **kw)


def _cfg(case):
    from repro_torch.configs.base import get_config
    arch, kw, _ = CASES[case]
    return dataclasses.replace(get_config(arch).reduced(), **kw)


def _heads(cfg) -> int:
    return cfg.ssm_nheads if cfg.family == "ssm" else cfg.n_heads


def _batch(cfg):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    out = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def _rows(grid):
    i = grid.axis_index("data")
    n = grid.shape[i]
    return slice(grid.coordinate[i] * B // n, (grid.coordinate[i] + 1) * B
                 // n)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ rank cases
def _case(rank, grid, case, weights):
    """The placed run of ``case`` with its counted bytes per step, this
    rank's head range, and on rank 0 one process's run on the whole
    batch (an MoE routed per batch row, under a one-point grid)."""
    from repro_torch.core.grid import ProcGrid
    from repro_torch.models.model_zoo import build, params_from_numpy
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import ctx, rules, tp
    from repro_torch.train.train_step import make_train_step
    cfg = _cfg(case)
    bundle = build(cfg, device="cpu")
    full = _batch(cfg)
    ocfg = AdamWConfig(**OPT)
    counted = []
    with ctx.use(grid, ("data",)):
        heads = tp.head_range(_heads(cfg))
        model = params_from_numpy(cfg, weights, device="cpu")
        rules.place_params(model, grid)
        step = make_train_step(bundle, ocfg, grid)
        got = _run(model, step, {k: v[_rows(grid)] for k, v in
                                 full.items()}, counted)
    out = {"got": got, "counted": counted, "heads": heads}
    if rank == 0:
        whole = params_from_numpy(cfg, weights, device="cpu")
        one = make_train_step(bundle, ocfg)
        if cfg.family == "moe":
            point = ProcGrid.create((1, 1), grid.axes, device="cpu")
            with ctx.use(point, None):
                out["want"] = _run(whole, one, full)
        else:
            out["want"] = _run(whole, one, full)
    return out


def _placement(grid, case, weights):
    """Each placed parameter against ``_block`` of the whole under its
    spec, the specs, and whether ``gather_params`` gives the whole back
    bitwise."""
    import torch
    from repro_torch.ckpt.checkpoint import _block
    from repro_torch.models.model_zoo import params_from_numpy
    from repro_torch.sharding import ctx, rules
    model = params_from_numpy(_cfg(case), weights, device="cpu")
    whole = {n: p.detach().clone() for n, p in model.named_parameters()}
    with ctx.use(grid, ("data",)):
        pl = rules.place_params(model, grid)
        back = rules.gather_params(model)
    bad = [n for n, p in model.named_parameters() if not torch.equal(
        p.detach(), whole[n][_block(pl.shapes[n], pl.specs[n], grid)])]
    return {"bad_blocks": bad, "specs": dict(pl.specs),
            "whole_back": all(torch.equal(back[n], whole[n])
                              for n in whole)}


def _grid_ranks(rank, grid_key, weights, ckpt_dir=None):
    from repro_torch.core.grid import ProcGrid
    grid = ProcGrid.create(*GRIDS[grid_key], device="cpu")
    out = {}
    for case, (_, _, g) in CASES.items():
        if g == grid_key:
            w = _load(weights[case])
            out[case] = {"placement": _placement(grid, case, w),
                         **_case(rank, grid, case, w)}
    if ckpt_dir is not None:
        from repro_torch.launch.train import main
        tr = main(["--arch", "whisper-small", "--preset", "cpu-ci",
                   "--grid", "1x8", "--steps", "4", "--seq", str(S),
                   "--fixed-batch", "--ckpt-dir", ckpt_dir,
                   "--device", "cpu"])
        out["launcher"] = {"placed": tr.placed,
                           "losses": [h["loss"] for h in tr.history]}
    return out


# --------------------------------------------------------- the arithmetic
def _arithmetic(cfg, grid_shape, axes) -> dict:
    """``chip_smoke.py``'s counted-bytes arithmetic of ``cfg``'s placed
    step on ``grid_shape`` (one microbatch of ``B`` × ``S`` tokens)."""
    from repro_torch.core.grid import ProcGrid
    from repro_torch.launch.dryrun import param_leaves
    from repro_torch.models.model_zoo import build
    cs = _chip_smoke()
    grid = ProcGrid.create_abstract(grid_shape, axes)
    leaves = param_leaves(build(cfg, device="meta").init(None), grid)
    Pd = int(np.prod([n for n, a in zip(grid_shape, axes) if a != "model"]))
    if cfg.family == "moe":
        return cs.ep_counted_bytes(cfg, leaves, grid, tokens=B // Pd * S,
                                   microbatches=1)
    return cs.tp_counted_bytes(cfg, leaves, grid, tokens=B // Pd * S,
                               enc_tokens=B // Pd * cfg.enc_seq,
                               microbatches=1)


# ------------------------------------------------------------- fixtures
_REF = """
import os; os.nice(19)  # the lowest CPU priority, as the ranks'
import dataclasses
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


arch, kw, weights, batch_path, shape, axes, out = {job!r}
cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
bundle = build(cfg)
init = bundle.init(jax.random.PRNGKey(0))
np.savez(weights, **flat(init))
d = np.load(batch_path)
batch = {{k: jnp.asarray(d[k]) for k in d.files}}
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
    """The reference's ``PRNGKey(0)`` weights of each case (saved flat)
    and its placed steps on the case's mesh: ({case: weights file},
    {case: (losses, norms, parameters)})."""
    from concurrent.futures import ThreadPoolExecutor
    d = tmp_path_factory.mktemp("ref")
    scripts, weights = [], {}
    for case, (arch, kw, g) in CASES.items():
        batch = str(d / f"{case}-batch.npz")
        np.savez(batch, **_batch(_cfg(case)))
        weights[case] = str(d / f"{case}-weights.npz")
        job = (arch, kw, weights[case], batch, GRIDS[g][0], GRIDS[g][1],
               str(d / f"{case}.npz"))
        scripts.append(_REF.format(job=job, opt=OPT, steps=STEPS))
    # one subprocess a case, side by side (each mostly compiles)
    with ThreadPoolExecutor(len(scripts)) as pool:
        outs = list(pool.map(lambda s: dist(s, n_devices=8), scripts))
    assert all("OK" in o for o in outs)
    out = {}
    for case in CASES:
        ref = np.load(str(d / f"{case}.npz"))
        out[case] = (list(ref["losses"]), list(ref["norms"]), _unflatten(
            {k[2:]: ref[k] for k in ref.files if k.startswith("p/")}))
    return weights, out


@pytest.fixture(scope="module")
def reference(run_reference):
    return run_reference[1]


@pytest.fixture(scope="module")
def four(run_reference, tmp_path_factory):
    return _spawn(_grid_ranks, 4, args=("2x2", run_reference[0]),
                  rendezvous_dir=str(tmp_path_factory.mktemp("rdv4")))


@pytest.fixture(scope="module")
def eight(run_reference, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("launcher"))
    return _spawn(_grid_ranks, 8, args=("1x8", run_reference[0], ckpt),
                  rendezvous_dir=str(tmp_path_factory.mktemp("rdv8")))


@pytest.fixture(scope="module")
def ranks(four, eight):
    return {"2x2": four, "1x8": eight}


def _of(ranks, case):
    return [r[case] for r in ranks[CASES[case][2]]]


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("case", CASES)
def test_uneven_steps_match_the_reference_mesh(case, ranks, reference):
    want = reference[case]
    for rank in _of(ranks, case):
        got = rank["got"]
        assert _rel(got[0], want[0]) <= 1e-6, (got[0], want[0])
        assert _rel(got[1], want[1]) <= 1e-6, (got[1], want[1])
        assert _tree_err(got[2], want[2]) <= 1e-5


@pytest.mark.parametrize("case", CASES)
def test_uneven_first_step_gradient_equals_one_process(case, ranks):
    rank0 = _of(ranks, case)[0]
    got, want = rank0["got"], rank0["want"]
    assert _rel(got[0], want[0]) <= 1e-6, (got[0], want[0])
    assert _rel(got[1], want[1]) <= 1e-6, (got[1], want[1])
    assert _tree_err(got[3], want[3]) <= GRAD_TOL
    assert _tree_err(got[2], want[2]) <= 1e-5


@pytest.mark.parametrize("case", CASES)
def test_uneven_place_params_blocks_and_gather(case, ranks):
    """The reference's blocks, ``wq`` split by columns off the heads
    (the attention) or ``out_proj`` by rows off them (the SSD)."""
    cfg = _cfg(case)
    for rank in _of(ranks, case):
        assert rank["placement"]["bad_blocks"] == []
        assert rank["placement"]["whole_back"]
    specs = _of(ranks, case)[0]["placement"]["specs"]
    M = GRIDS[CASES[case][2]][0][1]
    fsdp = ("data",) if M == 2 else ()
    assert _heads(cfg) % M
    if cfg.family == "ssm":
        assert specs["layers.0.ssm.out_proj"] == (("model",), fsdp)
        assert cfg.d_inner % M == 0
        return
    prefix = {"encdec": "enc_layers.0.", "hybrid": "groups.0.attn.",
              "moe": "layers.0."}[cfg.family]
    assert specs[prefix + "wq"] == (fsdp, ("model",))
    assert specs[prefix + "wo"] == (("model",), fsdp)
    assert cfg.n_heads * cfg.head_dim % M == 0
    if cfg.family == "encdec":
        assert specs["cross.0.wq"] == (fsdp, ("model",))


@pytest.mark.parametrize("case", CASES)
def test_head_ranges_cover_every_head_once(case, ranks):
    """Rank r of M computes heads [r·H // M, (r+1)·H // M): together
    every head once; on (1, 8) with 4 heads half the ranks none."""
    H = _heads(_cfg(case))
    got = [r["heads"] for r in _of(ranks, case)]
    covered = sorted(h for h0, h1 in got for h in range(h0, h1))
    M = GRIDS[CASES[case][2]][0][1]
    assert covered == sorted(list(range(H)) * (len(got) // M))
    if H < M:
        assert sum(h1 == h0 for h0, h1 in got) == M - H


@pytest.mark.parametrize("case", CASES)
def test_uneven_counted_bytes_equal_the_arithmetic(case, ranks):
    want = _arithmetic(_cfg(case), *GRIDS[CASES[case][2]])
    for rank in _of(ranks, case):
        for counted in rank["counted"]:
            assert counted == want, (counted, want)


@pytest.mark.parametrize("arch,grid", [
    (a, g) for a in ("mamba2-370m", "recurrentgemma-9b", "whisper-small")
    for g in ("2x2", "2x2x2")])
def test_even_heads_keep_the_families_bytes(arch, grid):
    """Where M divides the heads the arithmetic adds nothing: it is
    ``test_torch_tp_families.py``'s ``_expected_bytes``, by which that
    file holds the counted bytes of those cases."""
    import test_torch_tp_families as fam
    cfg = fam._cfg(arch)
    assert _arithmetic(cfg, *fam.GRIDS[grid]) == \
        fam._expected_bytes(cfg, *fam.GRIDS[grid])


@pytest.mark.parametrize("grid", ["ep4", "ep8"])
def test_even_heads_keep_the_moe_bytes(grid):
    """The same for the expert-parallel MoE: ``ep_counted_bytes`` is
    ``test_torch_ep_train.py``'s ``_expected_bytes`` there."""
    import test_torch_ep_train as ep
    (shape, axes), n_experts, mb, _ = ep.CASES[grid]
    cfg = ep._cfg(n_experts=n_experts)
    assert cfg.n_heads % shape[-1] == 0
    cs = _chip_smoke()
    from repro_torch.core.grid import ProcGrid
    from repro_torch.launch.dryrun import param_leaves
    from repro_torch.models.model_zoo import build
    g = ProcGrid.create_abstract(shape, axes)
    leaves = param_leaves(build(cfg, device="meta").init(None), g)
    Pd = int(np.prod(shape[:-1]))
    assert cs.ep_counted_bytes(cfg, leaves, g, tokens=ep.B // Pd // mb *
                               ep.S, microbatches=mb) == \
        ep._expected_bytes(cfg, shape, axes, mb)


def test_launcher_trains_whisper_on_1x8(eight):
    for rank in eight:
        out = rank["launcher"]
        assert out["placed"]
        assert out["losses"] == eight[0]["launcher"]["losses"]
        assert out["losses"][-1] < out["losses"][0], out["losses"]


def test_module_imports_no_jax():
    src = open(os.path.abspath(__file__)).read()
    head = src[:src.index("_REF = ")]
    assert "import jax" not in head
