"""Seeded-violation fixtures for every rule of the port's linter
(``repro_torch.check.lint``), following the reference's
``tests/test_check_lint.py``.

Each rule gets a minimal source string that *must* trip it, a close
sibling that must *not*, and a ``# noqa: FFTB2xx`` escape hatch.  The
captured roots are the port's: a function passed to
``StepGraphs.capture``, the fused step's name and the plan executors;
``host_sync`` ends a graph on purpose and is never reported.
Plus the meta-tests: the port's tree lints clean, and the command line
(``python -m repro_torch.check``, run in-process) gives the reference's
exit statuses and, on ``benchmarks/baseline.json``, the reference's
codes.
"""
import pathlib
import textwrap

import pytest

import repro.check.__main__ as RCLI
from repro_torch.check.__main__ import main
from repro_torch.check.lint import TRACED_ROOTS, lint_paths, lint_source

REPO = pathlib.Path(__file__).parent.parent
BASELINE = str(REPO / "benchmarks" / "baseline.json")


def codes(diags):
    return [d.code for d in diags]


def lint(src, **kw):
    return lint_source(textwrap.dedent(src), "mod.py", **kw)


# -------------------------------------------------- FFTB201 host sync
CAPTURED_ITEM = """
    def step(rho, c):
        e = energy(rho, c)
        return e.item()

    def run(graphs, rho, c):
        graphs.warmup(step, rho, c)
        return graphs.capture(step, rho, c)
"""


def test_item_in_a_function_passed_to_capture():
    diags = lint(CAPTURED_ITEM)
    assert codes(diags) == ["FFTB201"]
    assert ".item()" in diags[0].message and "'step'" in diags[0].message
    assert diags[0].location.startswith("mod.py:")
    assert "host_sync" in diags[0].hint


def test_host_sync_reachable_through_helper():
    diags = lint("""
        def _mix(state, rho):
            return rho * float(state["alpha"].sum())

        def step(state, rho):
            return _mix(state, rho)

        out = graphs.capture(step, state, rho)
    """)
    assert codes(diags) == ["FFTB201"]
    assert "_mix" in diags[0].message and "float(" in diags[0].message


@pytest.mark.parametrize("stmt,what", [
    ("return x.tolist()", ".tolist()"),
    ("return x.cpu()", ".cpu()"),
    ("return x.numpy()", ".numpy()"),
    ("return int(torch.argmax(x))", "int(<device value>)"),
    ("return bool(torch.all(x))", "bool(<device value>)"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
    ("return torch.from_numpy(occ)", "torch.from_numpy"),
    ("return torch.as_tensor(occ, device=x.device)", "torch.as_tensor"),
    ("return torch.tensor(w, device=x.device)", "torch.tensor"),
    ("x[0] = 1.0", "item assignment of a Python scalar"),
    ("x[h, 0] = -2", "item assignment of a Python scalar"),
    # collectives wait on the host under gloo
    ("dist.all_reduce(x)", "dist.all_reduce(...) (a collective"),
    ("torch.distributed.barrier()", "torch.distributed.barrier(...)"),
    ("return basis.grid.all_reduce(x, (1,))", "without name="),
    ("return self.grid.replicate(x, (0,))", "without name="),
    ("return grid.all_reduce_host(1.0, (0,))", "with a host result"),
])
def test_every_host_sync_kind_under_capture(stmt, what):
    diags = lint(f"""
        import torch

        def jit_step(x, occ, w):
            {stmt}
    """)
    assert codes(diags) == ["FFTB201"], stmt
    assert what in diags[0].message


@pytest.mark.parametrize("stmt", [
    "a = float(np.float32(alpha))",          # host arithmetic
    "n = int(math.prod(shape))",
    "k = int(len(shape))",
    "t = torch.tensor([0.0, 1.0], device=x.device)",   # a literal
    "x[0] = y",                              # a device value, no upload
    "rhs = (torch.arange(4, device=x.device) == 3).float()",
    # a named grid collective is a split point (the grid's host_sync)
    "x = basis.grid.all_reduce(x, (1,), name='energy.all_reduce')",
    "x = grid.replicate(x, (0,), name='rows.replicate')",
    "x = plan.all_reduce(x)",                # not the grid's
])
def test_host_values_under_capture_are_fine(stmt):
    assert lint(f"""
        import math
        import numpy as np
        import torch

        def jit_step(x, y, w, alpha, shape):
            {stmt}
            return x
    """) == []


def test_host_sync_outside_captured_code_is_fine():
    assert lint("""
        def eager_report(x):
            return float(x.sum()), x.tolist(), x.item()
    """) == []


def test_graphs_host_sync_is_allowed():
    # eigh waits for the host; host_sync ends the graph around it, so
    # neither the call nor the function it runs is reported
    assert lint("""
        import torch
        from . import graphs

        def _eigh(g):
            w, v = torch.linalg.eigh(g)
            return w, v, bool(torch.isfinite(w).all())

        def step(g):
            w, v, ok = graphs.host_sync("eigh", _eigh, g)
            return v

        graphs_obj.capture(step, g)
    """) == []


def test_collective_run_through_host_sync_is_fine():
    # the exchange runs between two graphs: neither the host_sync call
    # nor the dist call inside the function it runs is reported
    assert lint("""
        import torch.distributed as dist
        from ..core.hostsync import host_sync

        def _exchange(send, group):
            recv = send.new_empty(send.shape)
            dist.all_to_all_single(recv, send, group=group)
            return recv

        def step(x, group):
            return host_sync("all_to_all", _exchange, x.contiguous(), group)

        graphs.capture(step, x, group)
    """) == []


def test_host_sync_noqa_suppresses():
    assert lint("""
        def step(x):
            return x.item()  # noqa: FFTB201 — read once, after the capture

        g.capture(step, x)
    """) == []
    # another code's noqa does not suppress it
    assert codes(lint("""
        def step(x):
            return x.item()  # noqa: FFTB202

        g.capture(step, x)
    """)) == ["FFTB201"]


def test_traced_roots_are_the_port_executors():
    assert TRACED_ROOTS == {"jit_step", "_raw_apply", "_raw_apply_lazy"}
    diags = lint("""
        class FftPlan:
            def _raw_apply(self, x):
                for st in self.stages:
                    x = st.apply(x)
                return x

        class FFTStage:
            def apply(self, x):
                return x * float(self.scale.sum())
    """)
    assert codes(diags) == ["FFTB201"]
    assert "'apply'" in diags[0].message


# ------------------------------------------------ FFTB202 plan builds
def test_plan_build_under_capture():
    diags = lint("""
        def step(basis, c):
            inv, fwd = basis.stacked_hamiltonian_plans()
            return fwd(inv(c))

        g.capture(step, basis, c)
    """)
    assert codes(diags) == ["FFTB202"]
    assert "stacked_hamiltonian_plans" in diags[0].message


def test_plan_fetched_before_the_capture_is_fine():
    assert lint("""
        def _jit_scf_loop(basis, c):
            plans = basis.stacked_hamiltonian_plans()

            def step(c):
                return plans[1](plans[0](c))

            return g.capture(step, c)
    """) == []


def test_plan_build_noqa_suppresses():
    assert lint("""
        def jit_step(basis, tables=None):
            if tables is None:
                tables = basis.stacked_band_tables(0)  # noqa: FFTB202
            return tables
    """) == []


# ------------------------------------------------ FFTB203 honest clock
def test_time_time_interval():
    diags = lint("""
        import time

        def bench(f):
            t0 = time.time()
            f()
            return time.time() - t0
    """)
    assert codes(diags) == ["FFTB203"]
    assert "perf_counter" in diags[0].hint


def test_time_time_epoch_stamp_is_fine():
    assert lint("""
        import time

        def record():
            return {"saved_at": time.time()}
    """) == []


# ------------------------------------------- FFTB204 unsynced window
def test_perf_counter_window_without_sync():
    diags = lint("""
        import time
        import torch

        def bench(x):
            t0 = time.perf_counter()
            y = torch.fft.fft(x)
            return time.perf_counter() - t0
    """)
    assert codes(diags) == ["FFTB204"]
    assert "enqueue" in diags[0].hint


@pytest.mark.parametrize("marker", [
    "torch.cuda.synchronize()",
    "stop.synchronize()",
    "ms = start.elapsed_time(stop)",
    "v = y.abs().max().item()",
    "sync(torch, y.device)",
    "ms = time_ms(torch, lambda: y)",
])
def test_perf_counter_window_with_a_sync_marker_is_fine(marker):
    assert lint(f"""
        import time
        import torch

        def bench(x, start, stop):
            t0 = time.perf_counter()
            y = torch.fft.fft(x)
            {marker}
            return time.perf_counter() - t0
    """) == []


def test_perf_counter_window_around_host_work_is_fine():
    assert lint("""
        import time
        import torch

        def plan_build(spec):
            t0 = time.perf_counter()
            dev = torch.device("cuda")
            plan = search(spec, dev)
            return plan, time.perf_counter() - t0
    """) == []


def test_perf_counter_noqa_suppresses():
    assert lint("""
        import time
        import torch

        def enqueue_cost(x):
            t0 = time.perf_counter()
            torch.fft.fft(x)
            return time.perf_counter() - t0  # noqa: FFTB204 — enqueue
    """) == []


# ---------------------------------------------- FFTB205 bare locks
def test_bare_lock_on_serving_path():
    src = """
        import threading

        class Scheduler:
            def __init__(self):
                self._lock = threading.Lock()
    """
    diags = lint_source(textwrap.dedent(src),
                        "src/repro_torch/serve/scheduler.py")
    assert codes(diags) == ["FFTB205"]
    assert "TrackedLock" in diags[0].hint
    assert codes(lint_source("import threading\nL = threading.RLock()\n",
                             "src/repro_torch/core/cache.py")) == ["FFTB205"]


def test_bare_lock_elsewhere_and_in_locks_module_is_fine():
    src = "import threading\n_lock = threading.Lock()\n"
    assert lint_source(src, "src/repro_torch/core/local_fft.py") == []
    assert lint_source(src, "src/repro_torch/check/locks.py") == []
    assert lint_source(src + "# noqa: FFTB205\n",
                       "src/repro_torch/serve/x.py") != []
    assert lint_source(src.replace("Lock()", "Lock()  # noqa: FFTB205"),
                       "src/repro_torch/serve/x.py") == []


# -------------------------------------------------------- meta checks
def test_syntax_error_is_reported_not_raised():
    diags = lint_source("def broken(:\n", "bad.py")
    assert codes(diags) == ["FFTB201"]
    assert "cannot parse" in diags[0].message


def test_extra_roots_extend_reachability():
    src = """
        def my_kernel(x):
            return x.item()
    """
    assert lint(src) == []
    assert codes(lint(src, extra_roots=("my_kernel",))) == ["FFTB201"]


def test_port_tree_lints_clean():
    """src/repro_torch has zero lint findings (the step's captured code
    included)."""
    diags = lint_paths([REPO / "src" / "repro_torch"])
    assert not diags, "\n".join(d.render() for d in diags)


def test_port_tree_finds_a_seeded_fault(tmp_path):
    """The captured step of the port's SCF is a root: an ``.item()``
    seeded into the step body of ``_jit_scf_loop`` is reported."""
    src = (REPO / "src/repro_torch/dft/scf.py").read_text()
    anchor = "        rho.copy_(rho_next)\n"
    assert anchor in src
    bad = tmp_path / "scf.py"
    bad.write_text(src.replace(anchor, anchor + "        resid.item()\n"))
    diags = lint_paths([bad])
    assert codes(diags) == ["FFTB201"] and "'step'" in diags[0].message


# ------------------------------------------------------------ the CLI
def test_cli_lint_exit_statuses(tmp_path, capsys):
    assert main(["lint", str(REPO / "src" / "repro_torch")]) == 0
    assert "0 error(s)" in capsys.readouterr().out
    bad = tmp_path / "bad.py"
    bad.write_text("def jit_step(x):\n    return x.item()\n")
    assert main(["lint", str(bad)]) == 1
    assert "FFTB201" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        main(["lint"])
    assert exc.value.code == 2


def test_cli_codes(capsys):
    assert main(["codes"]) == 0
    out = capsys.readouterr().out
    assert "FFTB301" in out and "FFTB118" in out


def test_cli_preflight_baseline_equals_reference(capsys):
    assert main(["preflight", BASELINE]) == 0
    ours = capsys.readouterr().out
    assert RCLI.main(["preflight", BASELINE]) == 0
    ref = capsys.readouterr().out
    assert "7 config(s) audited, 0 error(s), 0 warning(s)" in ours
    assert ours.replace("repro_torch.check", "repro.check") == ref
    assert main(["preflight", BASELINE, "--scenario", "scf-pallas"]) == 0
    assert "1 config(s) audited" in capsys.readouterr().out
    assert main(["preflight", BASELINE, "--scenario", "nope"]) == 2


def test_cli_preflight_config_errors(tmp_path, capsys):
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"n": 16, "diameter": 0, "nbands": 4}')
    assert main(["preflight", str(cfg)]) == 1
    assert "FFTB116" in capsys.readouterr().out
    assert RCLI.main(["preflight", str(cfg)]) == 1
    assert "FFTB116" in capsys.readouterr().out
