"""``repro_torch.check`` — coded diagnostics for specs, bases, services,
source and locks.

Three analyzers, one :class:`~repro_torch.check.diagnostics.Diagnostic`
currency, with the reference package's codes:

* :mod:`repro_torch.check.preflight` — feasibility diagnostics for
  transform specs, plane-wave bases, service configurations, single
  requests and benchmark records *before any device work*: spec-DSL
  well-formedness, grid divisibility, shape/dtype contracts, backend and
  cache-budget feasibility, each with a stable ``FFTB1xx`` code and a
  fix hint.  ``fftb.preflight(...)`` is the public alias.
* :mod:`repro_torch.check.lint` — a stdlib-``ast`` linter for the
  invariants that break this program (``FFTB2xx``): host syncs and plan
  builds inside CUDA-graph-captured code, dishonest clocks, bare locks on
  the serving path.
* :mod:`repro_torch.check.locks` — an instrumented lock wrapper recording
  the per-thread held-lock graph; detects lock-order cycles and
  lock-held-across-dispatch hazards (``FFTB3xx``).  Free when disabled.

``diagnostics``, ``locks`` and ``lint`` use the standard library only, so
the core and serve layers can depend on them; ``preflight`` imports
``core`` lazily inside its checks, so ``core → check`` stays acyclic.
``python -m repro_torch.check lint|preflight|codes`` is the command line.
"""

from .diagnostics import (CODES, Diagnostic, DiagnosticError, Severity,
                          raise_if_errors, render_diagnostics)
from .locks import (LockOrderError, TrackedLock, check_dispatch_hazard,
                    disable_lock_checking, enable_lock_checking,
                    lock_violations)
from .preflight import (check_transform, preflight, preflight_basis,
                        preflight_config, preflight_request,
                        preflight_scenario, preflight_service,
                        preflight_transform)

__all__ = [
    "CODES", "Diagnostic", "DiagnosticError", "Severity",
    "raise_if_errors", "render_diagnostics",
    "TrackedLock", "LockOrderError", "enable_lock_checking",
    "disable_lock_checking", "check_dispatch_hazard", "lock_violations",
    "preflight", "preflight_transform", "preflight_basis",
    "preflight_service", "preflight_request", "preflight_config",
    "preflight_scenario", "check_transform",
]
