"""repro_torch.ckpt: the reference's checkpoint tests (``tests/test_ckpt.py``)
mirrored on the port, plus what the port's format adds.

* Round trip, async commit, keep-k GC, partial writes invisible, trainer
  resume and preemption: as the reference's tests, values exact.
* The manifest names each leaf by its key path (no JAX treedef), and a
  bfloat16 tensor is stored as its int16 view with ``"dtype":
  "bfloat16"``: every file loads with plain ``np.load(...,
  allow_pickle=False)`` and the restored tensor is bitwise the saved one.
* A spec'd restore on a one-point grid gives the whole array; on a
  two-point grid (2 gloo processes) each rank gets its block of the split
  dim, and a spec axis the grid lacks is dropped.
* The port's checkpoint of a reduced model and its optimizer state
  restores into the reference's tree layout (names, stacked leaves).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager


@pytest.fixture
def tree():
    return {"params": {"w": torch.arange(64.0).reshape(8, 8),
                       "b": torch.ones((8,))},
            "step": torch.tensor(7)}


def test_roundtrip(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path), keep=2)
    cm.save(10, tree, block=True)
    step, rt = cm.restore()
    assert step == 10
    np.testing.assert_array_equal(rt["params"]["w"],
                                  tree["params"]["w"].numpy())
    assert rt["step"] == 7


def test_async_save_visible_after_wait(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path), keep=2)
    cm.save(5, tree)
    cm.wait()
    assert cm.latest_step() == 5


def test_async_save_snapshots_before_returning(tmp_path, tree):
    """The caller may overwrite its tensors in place at once (the train
    step does): the write uses the host copy taken in ``save``."""
    cm = CheckpointManager(str(tmp_path), keep=2)
    want = tree["params"]["w"].clone()
    cm.save(5, tree)
    tree["params"]["w"].add_(1000.0)
    cm.wait()
    np.testing.assert_array_equal(cm.restore()[1]["params"]["w"],
                                  want.numpy())


def test_keep_k_gc(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, tree, block=True)
    assert cm.all_steps() == [3, 4]


def test_partial_write_invisible(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path), keep=3)
    cm.save(1, tree, block=True)
    # crash simulation: tmp dir and manifest-less dir must be ignored
    os.makedirs(tmp_path / "step_00000009.tmp")
    os.makedirs(tmp_path / "step_00000008")
    (tmp_path / "step_00000008" / "arr_0.npy").write_bytes(b"junk")
    assert cm.latest_step() == 1
    step, rt = cm.restore()
    assert step == 1


def test_no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore()


def test_bf16_is_stored_as_int16_and_restored_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)
                         ).to(torch.bfloat16)
    layers = [torch.from_numpy(rng.standard_normal(6).astype(np.float32)
                               ).to(torch.bfloat16) for _ in range(3)]
    cm = CheckpointManager(str(tmp_path))
    cm.save(2, {"w": w, "stack": layers, "n": torch.tensor(3)},
            {"w": ("data", None), "stack": (), "n": ()}, block=True)
    d = tmp_path / "step_00000002"
    meta = json.loads((d / "manifest.json").read_text())
    by_name = {lm["name"]: lm for lm in meta["leaves"]}
    assert set(by_name) == {"w", "stack", "n"}
    assert by_name["w"]["dtype"] == by_name["stack"]["dtype"] == "bfloat16"
    assert by_name["w"]["spec"] == ["data", None]
    assert by_name["stack"]["shape"] == [3, 6]
    for lm in meta["leaves"]:           # plain numpy reads every file
        arr = np.load(d / lm["file"], allow_pickle=False)
        assert list(arr.shape) == lm["shape"]
        if lm["dtype"] == "bfloat16":
            assert arr.dtype == np.int16
    _, rt = cm.restore()
    assert rt["w"].dtype == torch.bfloat16
    assert torch.equal(rt["w"].view(torch.int16), w.view(torch.int16))
    assert torch.equal(rt["stack"], torch.stack(layers))
    assert int(rt["n"]) == 3


def test_spec_restore_on_a_one_point_grid(tmp_path, tree):
    """The reference's ``test_elastic_restore_to_other_mesh`` on the
    port's grids: one point holds the whole array; an axis the grid lacks
    is dropped."""
    from repro_torch.launch.mesh import make_host_grid
    cm = CheckpointManager(str(tmp_path))
    specs = {"params": {"w": ("data", "model"), "b": ()}, "step": ()}
    cm.save(3, tree, specs, block=True)
    grid = make_host_grid((1, 1), ("data", "model"), device="cpu")
    step, rt = cm.restore(grid=grid, specs_tree=specs)
    np.testing.assert_array_equal(rt["params"]["w"].numpy(),
                                  tree["params"]["w"].numpy())
    grid1 = make_host_grid((1,), ("data",), device="cpu")
    _, rt1 = cm.restore(grid=grid1)           # the manifest's specs
    np.testing.assert_array_equal(rt1["params"]["w"].numpy(),
                                  tree["params"]["w"].numpy())


def _two_point_restore(rank, root):
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_host_grid
    cm = CheckpointManager(root)
    out = {}
    grid = make_host_grid((2,), ("data",), device="cpu")
    _, rt = cm.restore(grid=grid)
    out["data"] = {k: v.numpy() for k, v in rt["params"].items()}
    grid2 = make_host_grid((1, 2), ("data", "model"), device="cpu")
    _, rt2 = cm.restore(grid=grid2)
    out["model"] = rt2["params"]["w"].numpy()
    return out


def test_spec_restore_on_a_two_point_grid(tmp_path, tree):
    from repro_torch.sharding.procs import run_ranks
    root = str(tmp_path / "ck")
    cm = CheckpointManager(root)
    cm.save(3, tree, {"params": {"w": ("data", "model"), "b": ("data",)},
                      "step": ()}, block=True)
    outs = run_ranks(_two_point_restore, 2, args=(root,), nice=19,
                     rendezvous_dir=str(tmp_path / "rdv"), timeout=120)
    w = tree["params"]["w"].numpy()
    for r, out in enumerate(outs):
        # ("data", "model") on a [2] data grid: rows split, "model" dropped
        np.testing.assert_array_equal(out["data"]["w"], w[4 * r:4 * r + 4])
        np.testing.assert_array_equal(out["data"]["b"],
                                      np.ones(8)[4 * r:4 * r + 4])
        # on a 1×2 (data, model) grid: columns split over "model"
        np.testing.assert_array_equal(out["model"], w[:, 4 * r:4 * r + 4])


# --------------------------------------------- trainer, as the reference
def _trainer_parts(tmp_path, total, every, **kw):
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model_zoo import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import TrainerConfig
    cfg = get_config("tinyllama-1.1b").reduced()
    bundle = build(cfg, device="cpu")
    dcfg = DataConfig(vocab=cfg.vocab, seq=16, global_batch=2)
    tcfg = TrainerConfig(total_steps=total, ckpt_every=every,
                         log_every=100, ckpt_dir=str(tmp_path), **kw)
    return bundle, dcfg, tcfg, AdamWConfig


def test_trainer_resumes_from_checkpoint(tmp_path):
    """Kill training mid-run; a fresh Trainer must continue, not restart."""
    from repro_torch.train.trainer import Trainer
    bundle, dcfg, tcfg, A = _trainer_parts(tmp_path, 4, 2)
    ocfg = A(lr=1e-3, warmup_steps=0, total_steps=10)
    t1 = Trainer(bundle, ocfg, tcfg, dcfg)
    t1.run()
    assert t1.ckpt.latest_step() == 4
    _, _, tcfg2, _ = _trainer_parts(tmp_path, 6, 2)
    t2 = Trainer(bundle, ocfg, tcfg2, dcfg)
    t2.run()
    assert t2.history[0]["step"] == 4
    assert t2.ckpt.latest_step() == 6


def test_trainer_preemption_checkpoint(tmp_path):
    from repro_torch.train.trainer import Trainer
    bundle, dcfg, tcfg, A = _trainer_parts(tmp_path, 100, 1000)
    t = Trainer(bundle, A(warmup_steps=0), tcfg, dcfg)
    t._stop = True                      # simulate SIGTERM delivery
    t.run()
    # stopped after step 0 but still committed a checkpoint
    assert t.ckpt.latest_step() == 1
    assert len(t.history) == 1


def test_trainer_checkpoint_is_the_reference_tree(tmp_path):
    """The trainer's checkpoint names its leaves as the reference's tree
    (stacked layer leaves) and holds exactly the state it ends with."""
    import jax
    from repro.configs.base import get_config as ref_config
    from repro.models.model_zoo import build as ref_build
    from repro.train.train_step import init_opt_state as ref_init
    from repro_torch.models.model_zoo import state_to_numpy
    from repro_torch.train.trainer import Trainer
    bundle, dcfg, tcfg, A = _trainer_parts(tmp_path, 2, 1000,
                                           compress_grads=True)
    t = Trainer(bundle, A(warmup_steps=0), tcfg, dcfg)
    params, opt = t.run()
    _, rt = t.ckpt.restore()
    rshapes = jax.eval_shape(ref_build(ref_config(
        "tinyllama-1.1b").reduced()).init, jax.random.PRNGKey(0))
    ropt = jax.eval_shape(lambda p: ref_init(p, compress=True), rshapes)
    want = {"params": rshapes, "opt": ropt}
    assert jax.tree.structure(jax.tree.map(lambda x: 0, rt)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, want))
    jax.tree.map(lambda a, b: np.testing.assert_equal(
        tuple(a.shape), tuple(b.shape)), rt, want)
    got = jax.tree.map(lambda x: x.numpy(), rt)
    jax.tree.map(np.testing.assert_array_equal, got["params"],
                 state_to_numpy(params))
    jax.tree.map(np.testing.assert_array_equal, got["opt"],
                 state_to_numpy(params, opt))
