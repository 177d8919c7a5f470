"""The port's train step, data parallel over 2 CPU processes (gloo).

Each rank holds the weights and the optimizer state and runs its rows of
the batch; the step averages the gradients and the loss over the grid's
batch axes before compression (``repro_torch.train.train_step``).  The
processes are spawned once (``repro_torch.sharding.procs.run_ranks``, a
``file://`` rendezvous in ``tmp_path``, each rank at the lowest CPU
priority) and run every case; each rank also runs the one-process step
itself, with the same thread count, for the comparisons.

* A data-parallel step equals one process's step on the whole batch: 3
  steps of a reduced tinyllama (float32), every loss and grad_norm within
  1e-6 relative and the first step's gradient (as its first moment)
  within 1e-6 of its largest magnitude (sums over the halves in another
  order); the parameters after 3 steps within 1e-5 of their largest
  (Adam divides each gradient element by its own running RMS, so an
  element of tiny gradient carries its relative rounding into the
  update: measured 2.2e-6); the two ranks bitwise equal to each other.
  With compression, each rank holds the rows that one process's
  microbatch of the same index holds (rows r::2), so the averaged
  gradient is bitwise the one process's accumulated one and the int8
  codes cannot flip: the same limits, measured exactly 0.
* The reference's ``test_distributed_train_step_runs`` (a (pod, data,
  model) grid, 2 microbatches) and ``test_grad_compression_train_step_
  runs``: the loss of a memorised batch falls.
* The ``Trainer`` over the same grid: rank r draws shard r of 2 of each
  batch, only rank 0 writes the checkpoint, and the losses equal one
  process's ``Trainer`` on the whole batch (1e-6 relative).
* Against the reference's own step on a 2-device data mesh (the ``dist``
  fixture, 2 forced host devices) from the same weights: loss and
  grad_norm within 1e-5 relative at each of 3 steps, parameters within
  1e-4 of their largest magnitude (as the one-process comparison in
  ``test_torch_train.py``).

The module imports no JAX: the ranks import it to find their functions;
the reference runs in the ``dist`` fixture's subprocess.
"""
import os

import numpy as np
import pytest

ARCH = "tinyllama-1.1b"
B, S, STEPS = 8, 16, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TIMEOUT = 240


def _spawn(fn, nprocs, **kw):
    """``run_ranks`` at the lowest CPU priority (the ranks share the host
    with the rest of the test suite)."""
    from repro_torch.sharding.procs import run_ranks
    return run_ranks(fn, nprocs, nice=19, timeout=TIMEOUT, **kw)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
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


def _run(model, step, batch, steps=STEPS, opt=None, compress=False):
    """``steps`` steps; (losses, grad norms, final params tree, the first
    moment after the first step: (1 - β₁)·its gradient)."""
    import torch
    from repro_torch.models.model_zoo import state_to_numpy
    from repro_torch.train.train_step import init_opt_state
    opt = opt or init_opt_state(model, compress=compress)
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in batch.items()}
    losses, norms, first = [], [], None
    for _ in range(steps):
        model, opt, met = step(model, opt, tb)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        if first is None:
            first = state_to_numpy(model, {"m": opt["m"]})["m"]
    return losses, norms, state_to_numpy(model), first


def _two_ranks(rank, init_path, ckpt_dir):
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.grid import ProcGrid
    from repro_torch.models.model_zoo import build, params_from_numpy
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import ctx
    from repro_torch.train.train_step import make_train_step
    cfg = get_config(ARCH).reduced()
    bundle = build(cfg, device="cpu")
    init = _unflatten(dict(np.load(init_path)))

    def fresh():
        return params_from_numpy(cfg, init, device="cpu")
    full = _batch()
    out = {}
    grid = ProcGrid.create([2], ("data",), device="cpu")
    with ctx.use(grid, ("data",)):
        for mb, compress in ((1, False), (2, False), (1, True)):
            step = make_train_step(bundle, AdamWConfig(**OPT), grid,
                                   microbatches=mb, compress=compress)
            # compressed: the rows of one process's microbatch r (see the
            # module docstring); else this rank's contiguous half
            rows = slice(rank, None, 2) if compress else \
                slice(rank * B // 2, (rank + 1) * B // 2)
            mine = {k: v[rows] for k, v in full.items()}
            out[("dp", mb, compress)] = _run(fresh(), step, mine,
                                             compress=compress)
        # the reference's test_distributed_train_step_runs' run: 3 steps
        # of a memorised batch, 2 microbatches
    g3 = ProcGrid.create([1, 2, 1], ("pod", "data", "model"), device="cpu")
    with ctx.use(g3, ("pod", "data")):
        step = make_train_step(bundle, AdamWConfig(warmup_steps=0), g3,
                               microbatches=2)
        out["mesh"] = _run(fresh(), step, {k: v[rank * 4:rank * 4 + 4]
                                           for k, v in full.items()})[0]
    with ctx.use(grid, ("data",)):
        step = make_train_step(bundle, AdamWConfig(warmup_steps=0), grid,
                               compress=True)
        out["compress_runs"] = _run(
            fresh(), step, {k: v[rank * 2:rank * 2 + 2] for k, v in
                            full.items()}, steps=4, compress=True)[0]
    # the Trainer over the grid: each rank draws its shard of the batch,
    # rank 0 writes the checkpoint
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    dcfg = DataConfig(vocab=cfg.vocab, seq=S, global_batch=B)

    def trainer(root, g):
        return Trainer(bundle, AdamWConfig(**OPT), TrainerConfig(
            total_steps=2, ckpt_every=1000, log_every=1000,
            ckpt_dir=os.path.join(ckpt_dir, root)), dcfg, grid=g)
    with ctx.use(grid, ("data",)):
        tr = trainer("dp", grid)
        tr.run()
    out["trainer"] = {"shard": (tr.pipeline.shard, tr.pipeline.n_shards),
                      "writer": tr.writer,
                      "losses": [h["loss"] for h in tr.history]}
    if rank == 0:
        one = trainer("one", None)
        one.run()
        out["trainer_one"] = [h["loss"] for h in one.history]
    # the one-process steps on the whole batch, in this process
    for mb, compress in ((1, False), (2, False), (2, True)):
        step = make_train_step(bundle, AdamWConfig(**OPT),
                               microbatches=mb, compress=compress)
        out[("one", mb, compress)] = _run(fresh(), step, full,
                                          compress=compress)
    del torch
    return out


_REF_INIT = """
import os; os.nice(19)  # the lowest CPU priority, as the ranks'
import numpy as np, jax
from repro.configs.base import get_config
from repro.models.model_zoo import build
cfg = get_config({arch!r}).reduced()
p = build(cfg).init(jax.random.PRNGKey(0))
flat = jax.tree_util.tree_flatten_with_path(p)[0]
np.savez({out!r}, **{{"/".join(k.key for k in path): np.asarray(v)
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
from repro.sharding import ctx
from repro.train.train_step import init_opt_state, make_train_step
assert jax.device_count() == 2
mesh = make_mesh((2,), ("data",))
cfg = get_config({arch!r}).reduced()
bundle = build(cfg)
d = np.load({batch!r})
batch = {{k: jnp.asarray(d[k]) for k in ("tokens", "labels")}}
with ctx.use(mesh, ("data",)):
    params = bundle.init(jax.random.PRNGKey(0))
    opt = init_opt_state(params)
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
def init(dist, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("init") / "init.npz")
    assert "OK" in dist(_REF_INIT.format(arch=ARCH, out=path), n_devices=1)
    return path


@pytest.fixture(scope="module")
def two(init, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    out = _spawn(_two_ranks, 2, args=(init, ckpt),
                 rendezvous_dir=str(tmp_path_factory.mktemp("rdv")))
    return out, ckpt


@pytest.fixture(scope="module")
def reference(dist, tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    batch, out = str(d / "batch.npz"), str(d / "out.npz")
    np.savez(batch, **_batch())
    assert "OK" in dist(_REF_STEP.format(arch=ARCH, batch=batch, out=out,
                                         opt=OPT, steps=STEPS),
                        n_devices=2)
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


CASES = [(1, False, 1), (2, False, 2), (1, True, 2)]


@pytest.mark.parametrize("mb,compress,one_mb", CASES,
                         ids=["plain", "microbatches", "compress"])
def test_data_parallel_step_equals_one_process(mb, compress, one_mb, two):
    two = two[0]
    got = two[0][("dp", mb, compress)]
    other = two[1][("dp", mb, compress)]
    # every rank ends with the same losses and weights
    assert got[0] == other[0] and got[1] == other[1]
    for k, v in _flat(got[2]):
        np.testing.assert_array_equal(v, dict(_flat(other[2]))[k])
    want = two[0][("one", one_mb, compress)]
    if compress:             # bitwise the one process's gradient: exact
        assert got[0] == want[0] and got[1] == want[1]
        assert _tree_err(got[2], want[2]) == 0.0
    assert _rel(got[0], want[0]) <= 1e-6
    assert _rel(got[1], want[1]) <= 1e-6
    assert _tree_err(got[3], want[3]) <= 1e-6
    assert _tree_err(got[2], want[2]) <= 1e-5


def test_distributed_train_step_runs(two):
    for out in two[0]:
        losses = out["mesh"]
        assert np.isfinite(losses[-1])
        assert losses[-1] < losses[0], losses


def test_grad_compression_train_step_runs(two):
    for out in two[0]:
        losses = out["compress_runs"]
        assert losses[-1] < losses[0], losses


def test_data_parallel_step_matches_the_reference_mesh(two, reference):
    losses, norms, params = reference
    got = two[0][0][("dp", 1, False)]
    assert _rel(got[0], losses) <= 1e-5
    assert _rel(got[1], norms) <= 1e-5
    assert _tree_err(got[2], params) <= 1e-4


def test_trainer_shards_the_batch_and_one_rank_writes(two):
    from repro_torch.ckpt.checkpoint import CheckpointManager
    outs, ckpt = two
    a, b = outs[0]["trainer"], outs[1]["trainer"]
    assert (a["shard"], b["shard"]) == ((0, 2), (1, 2))
    assert (a["writer"], b["writer"]) == (True, False)
    assert a["losses"] == b["losses"]
    assert _rel(a["losses"], outs[0]["trainer_one"]) <= 1e-6
    assert CheckpointManager(os.path.join(ckpt, "dp")).all_steps() == [2]


def test_module_imports_no_jax():
    src = open(os.path.abspath(__file__)).read()
    head = src[:src.index("_REF_INIT")]
    assert "import jax" not in head.replace("import jax, ", "")
