"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches must
see 1 device; multi-device tests spawn subprocesses (see dist_helper)."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def run_distributed(script: str, n_devices: int = 8, timeout: int = 300):
    """Run a python snippet in a subprocess with N virtual CPU devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=timeout,
                          check=False)
    if proc.returncode != 0:
        raise AssertionError(
            f"distributed subprocess failed:\nSTDOUT:\n{proc.stdout}\n"
            f"STDERR:\n{proc.stderr}")
    return proc.stdout


@pytest.fixture(scope="session")
def dist():
    return run_distributed


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skipped without one)")
