"""Expert parallelism: the port's MoE train step on placed weights whose
"model" axis splits the experts, over CPU processes (gloo).

Reduced Granite-MoE 3B-A800M (2 layers, d_model 64, 4 experts, top-2,
float32, the published ``capacity_factor`` 1.25), weights drawn by torch
from a seed, with ``SKEW`` added to the router's column of expert 0 so
that expert 0 overfills and the dispatch drops tokens (each case asserts
at least one drop, so no agreement here holds vacuously).  Each grid is
spawned once (``run_ranks`` at the lowest CPU priority, a ``file://``
rendezvous in ``tmp_path``) and runs every case; the reference's train
step runs on the same weights and batch in the ``dist`` fixture's
subprocess, on 8 forced host devices (the 2×2 meshes on the first 4).

* EP on 2×2 and on (2, 2, 2) against the reference's placed step on the
  same meshes: loss and grad_norm within 1e-6 relative at each of 3
  steps, parameters within 1e-5 of their largest; and against one
  process that routes as the grid does (per-row groups: a one-point
  ("data", "model") grid installed), the first step's gradient too
  (within ``GRAD_TOL``).
* The global dispatch (the reference's ``groups == 1``): 3 experts on 2×2
  (2 does not divide 3, so the experts stay whole and every token of a
  microbatch routes in one group across the two data ranks), 2
  microbatches, and 4 experts on a data-only grid of 4 (no "model" axis:
  the reference's weights stay replicated there, ``param_shardings``
  needing that axis), against the reference's step on the same meshes
  and against one process with no grid; routing each rank's rows alone
  (the port's earlier dispatch) is shown to give another result.
* ``place_params`` keeps experts [r·E/M, (r+1)·E/M) of every expert
  tensor on model rank r (and its "data" block of D or F), the router
  split over "data" only; ``gather_params`` is its bitwise inverse.
* The operand bytes that ``core/grid.py::COLLECTIVE_BYTES`` counts per
  step equal :func:`_expected_bytes`, PERF.md §5's arithmetic, to the
  byte.
* The ``Trainer`` on 2×2 places the MoE, checkpoints whole tensors and
  restores each rank's expert blocks bitwise; the launcher with
  ``--arch granite-moe-3b-a800m --grid 2x2`` trains placed.

The module imports no JAX: the ranks import it to find their functions;
the reference runs in the ``dist`` fixture's subprocess.
"""
import dataclasses
import os

import numpy as np
import pytest

ARCH = "granite-moe-3b-a800m"
B, S, STEPS = 8, 32, 3
OPT = dict(lr=1e-4, warmup_steps=1, total_steps=10)
TIMEOUT = 240
#: added to the router's column of expert 0: most tokens pick it
SKEW = 0.5
#: the first step's gradient (as its first moment) against one process,
#: of its largest magnitude: the tied embedding's gradient sums its
#: lookup and head parts over the vocab and data blocks in another order
#: (measured 1.0e-6 and 1.6e-6 there, every other leaf at most 2e-7)
GRAD_TOL = 5e-6
GRID4 = ((2, 2), ("data", "model"))
GRID8 = ((2, 2, 2), ("pod", "data", "model"))
GRID_DATA = ((4,), ("data",))
#: key → (grid, n_experts, microbatches, oracle routing): "rows" routes
#: per batch row (a one-point grid installed), "one" in one group
CASES = {"ep4": (GRID4, 4, 1, "rows"), "ep8": (GRID8, 4, 1, "rows"),
         "global": (GRID4, 3, 2, "one"), "data": (GRID_DATA, 4, 2, "one")}


def _spawn(fn, nprocs, **kw):
    from repro_torch.sharding.procs import run_ranks
    return run_ranks(fn, nprocs, nice=19, timeout=TIMEOUT, **kw)


def _cfg(**kw):
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(ARCH).reduced(), **kw)


def _batch(vocab=256):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


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
def _drop_spy(record):
    """Wrap ``moe._dispatch`` to append the (token, k) pairs each call
    drops (one process: counts over the capacity); returns the remover."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import moe
    real = moe._dispatch

    def spy(xg, router, p, cfg, C, **kw):
        with torch.no_grad():
            top = moe._top_k(xg.float() @ router, cfg.top_k)[1]
            counts = F.one_hot(top.reshape(xg.shape[0], -1),
                               cfg.n_experts).sum(1)
            record.append(int((counts - C).clamp(min=0).sum()))
        return real(xg, router, p, cfg, C, **kw)
    moe._dispatch = spy

    def remove():
        moe._dispatch = real
    return remove


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


def _case(grid, key, weights, *, local=False):
    """The placed run of case ``key`` on ``grid`` (with ``local`` each
    rank routing its own rows alone), its counted bytes per step, and,
    unless ``local``, one process's run routed as the grid routes, with
    its drops."""
    from repro_torch.core.grid import ProcGrid
    from repro_torch.models import moe
    from repro_torch.models.model_zoo import build, params_from_numpy
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import ctx, rules
    from repro_torch.train.train_step import make_train_step
    (_, axes), n_experts, mb, oracle = CASES[key]
    cfg = _cfg(n_experts=n_experts)
    bundle = build(cfg, device="cpu")
    full = _batch(cfg.vocab)
    ocfg = AdamWConfig(**OPT)
    batch_axes = _axes(axes)
    counted = []
    real = moe._row_block
    if local:
        moe._row_block = lambda: (0, 1, ())
    try:
        with ctx.use(grid, batch_axes):
            model = params_from_numpy(cfg, weights, device="cpu")
            rules.place_params(model, grid)
            step = make_train_step(bundle, ocfg, grid, microbatches=mb)
            rows = _rows(grid, batch_axes)
            got = _run(model, step, {k: v[rows] for k, v in full.items()},
                       counted)
    finally:
        moe._row_block = real
    if local:
        return {"got": got}
    drops = []
    remove = _drop_spy(drops)
    try:
        one = make_train_step(bundle, ocfg, microbatches=mb)
        whole = params_from_numpy(cfg, weights, device="cpu")
        if oracle == "rows":
            point = ProcGrid.create((1,) * len(axes), axes, device="cpu")
            with ctx.use(point, None):
                want = _run(whole, one, full)
        else:
            want = _run(whole, one, full)
    finally:
        remove()
    return {"got": got, "want": want, "counted": counted, "drops": drops}


def _placement(grid, weights):
    """Each expert tensor's block against the whole tensor's experts of
    this model rank (and its "data" block), the router's, and whether
    ``gather_params`` gives the whole back bitwise."""
    import torch
    from repro_torch.ckpt.checkpoint import _block
    from repro_torch.models.model_zoo import params_from_numpy
    from repro_torch.sharding import ctx, rules
    cfg = _cfg()
    model = params_from_numpy(cfg, weights, device="cpu")
    whole = {n: p.detach().clone() for n, p in model.named_parameters()}
    with ctx.use(grid, _axes(grid.axes)):
        pl = rules.place_params(model, grid)
        back = rules.gather_params(model)
    m = grid.coordinate[grid.axis_index("model")]
    M = grid.shape[grid.axis_index("model")]
    El = cfg.n_experts // M
    out = {"experts": {}, "specs": {n: pl.specs[n] for n in pl.specs
                                    if ".moe." in n}}
    for n, p in model.named_parameters():
        if ".moe." not in n:
            continue
        w = whole[n]
        if not n.endswith("router"):
            w = w[m * El:(m + 1) * El]          # this model rank's experts
            sp = ((),) + pl.specs[n][1:]
            w = w[_block(tuple(w.shape), sp, grid)]
        else:
            w = w[_block(tuple(w.shape), pl.specs[n], grid)]
        out["experts"][n] = (bool(torch.equal(p.detach(), w)),
                             tuple(p.shape))
    out["whole_back"] = all(torch.equal(back[n], whole[n]) for n in whole)
    return out


def _trainer_case(grid, ckpt_dir):
    """The Trainer on 2×2: 2 steps, a checkpoint of whole tensors, a
    second Trainer restoring each rank's blocks."""
    import torch
    import torch.distributed as dist
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model_zoo import build, reference_name, \
        stacked_lists
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import ctx, rules
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = _cfg()
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
        pl = rules.placement_of(p2)
        out["restored_step"] = start
        out["restored_blocks"] = all(
            torch.equal(p.detach(), mine[n])
            for n, p in p2.named_parameters()) and all(
            torch.equal(o2["v"][n], mine_v[n]) for n in mine_v)
        out["expert_blocks"] = all(
            tuple(p.shape)[0] == pl.shapes[n][0] // 2
            for n, p in p2.named_parameters()
            if ".moe.w_" in n)
    return out


def _four_ranks(rank, weights, ckpt_dir):
    from repro_torch.core.grid import ProcGrid
    grid = ProcGrid.create(*GRID4, device="cpu")
    out = {"placement": _placement(grid, _load(weights["ep4"]))}
    for key in ("ep4", "global"):
        out[key] = _case(grid, key, _load(weights[key]))
    out["data"] = _case(ProcGrid.create(*GRID_DATA, device="cpu"), "data",
                        _load(weights["data"]))
    out["global_local"] = _case(grid, "global", _load(weights["global"]),
                                local=True)
    out["trainer"] = _trainer_case(grid, os.path.join(ckpt_dir, "trainer"))
    from repro_torch.launch.train import main
    tr = main(["--arch", ARCH, "--preset", "cpu-ci", "--grid", "2x2",
               "--steps", "4", "--seq", str(S), "--fixed-batch",
               "--ckpt-dir", os.path.join(ckpt_dir, "launcher"),
               "--device", "cpu"])
    out["launcher"] = {"placed": tr.placed,
                       "losses": [h["loss"] for h in tr.history]}
    return out


def _eight_ranks(rank, weights):
    from repro_torch.core.grid import ProcGrid
    grid = ProcGrid.create(*GRID8, device="cpu")
    return {"placement": _placement(grid, _load(weights["ep8"])),
            "ep8": _case(grid, "ep8", _load(weights["ep8"]))}


def _load(path):
    return _unflatten(dict(np.load(path)))


# --------------------------------------------------------- the arithmetic
def _expected_bytes(cfg, grid_shape, axes, mb: int) -> dict:
    """Operand bytes per step and rank of the placed MoE step (remat
    "none", float32, tied embeddings, ``B`` × ``S`` tokens): PERF.md §5's
    arithmetic.  P_d: the batch axes' processes, M: the model axis', T:
    a rank's tokens per microbatch, L layers, a = 4."""
    shape = dict(zip(axes, grid_shape))
    M = shape.get("model", 1)
    Pd = int(np.prod([shape[a] for a in axes if a != "model"]))
    D, F, V, E, K = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_experts, \
        cfg.top_k
    H, Kh, hd, L, a = cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.n_layers, 4
    T = B // Pd // mb * S
    ep = M > 1 and E % M == 0
    El = E // M if ep else E
    # every FSDP-split leaf's block: the layer's and the embedding
    attn = (D * H * hd + 2 * D * Kh * hd + H * hd * D) // (Pd * M)
    experts = 3 * El * D * F // Pd
    router = D * E // Pd
    layer = (attn + experts + router) * a
    embed = V * D // (Pd * M) * a
    gather = mb * (L * layer + embed)
    # the global dispatch's per-expert counts (int64), each layer and
    # microbatch, where one group spans the data ranks (no "model" axis,
    # or one that does not divide the experts)
    counts = mb * L * E * 8 if "model" not in shape or E % M else 0
    rs = gather * Pd
    # the flat all-reduce of the unsplit leaves (ln1, ln2, ln_f) and the
    # loss; the global norm's one sum per set of splitting axes that has
    # a live axis: {batch axes, "model"} (where "model" splits) and
    # {batch axes}
    flat = (2 * L + 1) * D * 4 + 4
    norm = 4 * (2 if M > 1 else 1)
    tp = 0
    if M > 1:
        # attention: copy_to_model's backward and wo's reduce; the MoE
        # under EP: the input's and the router's backward and the
        # combine's reduce; the vocab-parallel embedding and (tied) head;
        # the loss's max, sum of exponentials and gold logit, in the
        # forward and in its chunk's recompute
        per_layer = 2 * T * D * a
        if ep:
            per_layer += 2 * T * D * a + D * E * 4
        tp = mb * (L * per_layer + 2 * T * D * a + 2 * 3 * T * 4)
    return {"all-gather": gather + counts, "reduce-scatter": rs,
            "all-reduce": flat + norm + tp, "all-to-all": 0}


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


def tree(flat):
    out = {{}}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {{}})
        node[leaf] = jnp.asarray(v)
    return out


d = np.load({batch!r})
batch = {{k: jnp.asarray(d[k]) for k in ("tokens", "labels")}}
for shape, axes, n_experts, mb, weights, out in {jobs!r}:
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    mesh = mesh_from_devices(devs, axes)
    cfg = dataclasses.replace(get_config({arch!r}).reduced(),
                              n_experts=n_experts)
    bundle = build(cfg)
    with ctx.use(mesh, tuple(a for a in axes if a != "model")):
        params = tree(dict(np.load(weights)))
        opt = init_opt_state(params)
        if "model" in axes:   # param_shardings needs the "model" axis
            params = jax.device_put(params,
                                    rules.param_shardings(params, mesh))
            opt = jax.device_put(opt, rules.param_shardings(opt, mesh))
        step = make_train_step(bundle, AdamWConfig(**{opt!r}), mesh,
                               microbatches=mb, donate=False)
        losses, norms = [], []
        for _ in range({steps}):
            params, opt, met = step(params, opt, batch)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
    flat = {{"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}}
    np.savez(out, losses=np.asarray(losses), norms=np.asarray(norms),
             **{{"p/" + k: v for k, v in flat.items()}})
print("OK")
"""


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Each case's weights, drawn by torch from seed 0, the router's
    expert-0 column skewed: reference-shaped trees saved flat."""
    import torch
    from repro_torch.models.model_zoo import build, state_to_numpy
    d = tmp_path_factory.mktemp("weights")
    out = {}
    for key, (_, n_experts, _, _) in CASES.items():
        cfg = _cfg(n_experts=n_experts)
        model = build(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        tree = state_to_numpy(model)
        tree["layers"]["moe"]["router"][..., 0] += SKEW
        out[key] = str(d / f"{key}.npz")
        np.savez(out[key], **dict(_flat(tree)))
    return out


@pytest.fixture(scope="module")
def reference(dist, weights, tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    batch = str(d / "batch.npz")
    np.savez(batch, **_batch())
    jobs = [(grid[0], grid[1], n_experts, mb, weights[key],
             str(d / f"{key}.npz"))
            for key, (grid, n_experts, mb, _) in CASES.items()]
    assert "OK" in dist(_REF.format(batch=batch, jobs=jobs, arch=ARCH,
                                    opt=OPT, steps=STEPS), n_devices=8)
    out = {}
    for key in CASES:
        ref = np.load(str(d / f"{key}.npz"))
        out[key] = (list(ref["losses"]), list(ref["norms"]), _unflatten(
            {k[2:]: ref[k] for k in ref.files if k.startswith("p/")}))
    return out


@pytest.fixture(scope="module")
def four(weights, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    return _spawn(_four_ranks, 4, args=(weights, ckpt),
                  rendezvous_dir=str(tmp_path_factory.mktemp("rdv4")))


@pytest.fixture(scope="module")
def eight(weights, tmp_path_factory):
    return _spawn(_eight_ranks, 8, args=(weights,),
                  rendezvous_dir=str(tmp_path_factory.mktemp("rdv8")))


def _ranks(four, eight, key):
    return eight if CASES[key][0] is GRID8 else four


def _tree_err(got, want) -> float:
    g, w = dict(_flat(got)), dict(_flat(want))
    assert set(g) == set(w)
    scale = max(float(np.abs(v).max()) for v in w.values())
    return max(float(np.abs(g[k] - w[k]).max()) for k in w) / scale


def _rel(a, b) -> float:
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def _agrees(got, want, first=True):
    assert _rel(got[0], want[0]) <= 1e-6, (got[0], want[0])
    assert _rel(got[1], want[1]) <= 1e-6, (got[1], want[1])
    if first:
        assert _tree_err(got[3], want[3]) <= GRAD_TOL
    assert _tree_err(got[2], want[2]) <= 1e-5


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("key", list(CASES))
def test_ep_steps_match_the_reference_mesh(key, four, eight, reference):
    for rank in _ranks(four, eight, key):
        _agrees(rank[key]["got"], reference[key], first=False)


@pytest.mark.parametrize("key", list(CASES))
def test_ep_steps_equal_one_process_routed_as_the_grid(key, four, eight):
    for rank in _ranks(four, eight, key):
        case = rank[key]
        assert sum(case["drops"]) > 0, case["drops"]
        _agrees(case["got"], case["want"])


def test_routing_each_ranks_rows_alone_differs(four, reference):
    """The fault the global dispatch repairs: with one group over the
    two data ranks' rows, routing each rank's rows alone changes the
    capacity and the drops, and the result leaves the reference's."""
    for rank in four:
        local = rank["global_local"]["got"]
        assert _rel(local[0], reference["global"][0]) > 1e-4
        assert _tree_err(local[2], reference["global"][2]) > 1e-4


@pytest.mark.parametrize("ranks", ["four", "eight"])
def test_place_params_keeps_each_model_ranks_experts(ranks, four, eight):
    outs = four if ranks == "four" else eight
    for rank in outs:
        case = rank["placement"]
        assert case["whole_back"]
        assert all(ok for ok, _ in case["experts"].values()), \
            case["experts"]
        fsdp = ("pod", "data") if ranks == "eight" else ("data",)
        assert case["specs"]["layers.0.moe.w_up"] == (("model",), fsdp, ())
        assert case["specs"]["layers.0.moe.w_down"] == (("model",), (),
                                                       fsdp)
        assert case["specs"]["layers.0.moe.router"] == (fsdp, ())
        assert case["experts"]["layers.1.moe.w_gate"][1][0] == 2


@pytest.mark.parametrize("key", list(CASES))
def test_counted_collective_bytes_equal_the_arithmetic(key, four, eight):
    (shape, axes), n_experts, mb, _ = CASES[key]
    want = _expected_bytes(_cfg(n_experts=n_experts), shape, axes, mb)
    for rank in _ranks(four, eight, key):
        for counted in rank[key]["counted"]:
            assert counted == want, (counted, want)


def test_trainer_restores_expert_blocks(four):
    outs = [r["trainer"] for r in four]
    assert all(o["placed"] for o in outs)
    assert outs[0]["ckpt_whole"]
    assert all(o["restored_step"] == 2 and o["restored_blocks"]
               and o["expert_blocks"] for o in outs)


def test_launcher_trains_the_moe_on_2x2(four):
    for rank in four:
        out = rank["launcher"]
        assert out["placed"]
        assert out["losses"] == four[0]["launcher"]["losses"]
        assert out["losses"][-1] < out["losses"][0], out["losses"]


def test_module_imports_no_jax():
    src = open(os.path.abspath(__file__)).read()
    head = src[:src.index("_REF = ")]
    assert "import jax" not in head
