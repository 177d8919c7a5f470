"""The port's examples (``examples/torch_*.py``) on the CPU, each at its
smallest size, against the reference where the reference gives a number.

Each example keeps its reference script's own assertions (they raise
here if they fail); the tests add what the reference's numbers decide:
the SCF energy of ``torch_planewave_dft`` against the reference's
``run_scf`` on the same configuration (rel. 1e-4, PERF.md §2), and the
fourier-mixer LM's forward on the reference example's own weights
(1e-5 of the largest logit: float32 sums in another order).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax

ROOT = os.path.join(os.path.dirname(__file__), "..", "examples")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs test files in parallel workers; two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_quickstart_errors_under_the_reference_limits():
    out = _example("torch_quickstart").main(["--device", "cpu"])
    assert out["err"] < 1e-5 and out["roundtrip"] < 1e-4
    assert out["cache"]["hits"] >= 1


def test_planewave_dft_energy_matches_the_reference():
    from repro.core import ExecPolicy
    from repro.dft import SCFConfig, run_scf
    from repro.sharding.grids import choose_dft_grid
    res = _example("torch_planewave_dft").main(
        ["--device", "cpu", "--iters", "4"])
    kpts = ((0.0, 0.0, 0.0), (0.5, 0.5, 0.5))
    cfg = SCFConfig(n=16, nbands=4, kpts=kpts, max_iter=4,
                    policy=ExecPolicy.from_mode("eager"))
    # one device, as the port's run on one process (the worker's JAX may
    # have been started with more)
    want = run_scf(cfg, grid=choose_dft_grid(1, nbands=4, nk=2, diameter=8))
    assert res.iterations == want.iterations == 4
    assert abs(res.energy - want.energy) <= 1e-4 * abs(want.energy)


def test_serve_transforms_serves_every_request_within_the_limit():
    mod = _example("torch_serve_transforms")
    out = mod.main(["--device", "cpu", "--requests", "8"])
    assert out["metrics"]["requests"] == len(out["results"]) == 8
    assert out["max_rel_err"] <= mod.RTOL


def test_fourier_mixer_lm_forward_matches_the_reference_and_trains():
    from repro.data.pipeline import DataConfig, Pipeline
    ref = _example("fourier_mixer_lm")
    mod = _example("torch_fourier_mixer_lm")
    tree = jax.tree.map(np.asarray, ref.init_params(
        jax.random.PRNGKey(0), 256, 64, 2, 128))
    params = mod.params_from_reference(tree, device="cpu")
    tokens = Pipeline(DataConfig(vocab=256, seq=32, global_batch=4)
                      ).batch_at(0)["tokens"]
    want = np.asarray(ref.forward(tree, tokens))
    with torch.no_grad():
        got = mod.forward(params, torch.as_tensor(tokens).long()).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    losses = mod.main(["--steps", "6", "--device", "cpu"])["losses"]
    assert losses[-1] < losses[0]


def test_serve_lm_serves_every_request():
    reqs = _example("torch_serve_lm").main(
        ["--device", "cpu", "--requests", "3", "--max-new", "4"])
    assert len(reqs) == 3 and all(r.done and len(r.out) == 4 for r in reqs)


def test_train_lm_loss_falls(tmp_path):
    losses = _example("torch_train_lm").main(
        ["--device", "cpu", "--steps", "20", "--seq", "64",
         "--global-batch", "4", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert len(losses) == 20
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
