"""``repro_torch.check`` — coded diagnostics for specs, services and locks.

Two analyzers, one :class:`~repro_torch.check.diagnostics.Diagnostic`
currency, with the reference package's codes:

* :mod:`repro_torch.check.preflight` — feasibility diagnostics for
  transform specs, service configurations and single requests *before
  any device work*: spec-DSL well-formedness, grid divisibility,
  shape/dtype contracts, each with a stable ``FFTB1xx`` code and a fix
  hint.  ``fftb.preflight(...)`` is the public alias.
* :mod:`repro_torch.check.locks` — an instrumented lock wrapper recording
  the per-thread held-lock graph; detects lock-order cycles and
  lock-held-across-dispatch hazards (``FFTB3xx``).  Free when disabled.

``diagnostics`` and ``locks`` use the standard library only, so the core
and serve layers can depend on them; ``preflight`` imports ``core`` lazily
inside its checks, so ``core → check`` stays acyclic.
"""

from .diagnostics import (CODES, Diagnostic, DiagnosticError, Severity,
                          raise_if_errors, render_diagnostics)
from .locks import (LockOrderError, TrackedLock, check_dispatch_hazard,
                    disable_lock_checking, enable_lock_checking,
                    lock_violations)
from .preflight import (check_transform, preflight, preflight_config,
                        preflight_request, preflight_service,
                        preflight_transform)

__all__ = [
    "CODES", "Diagnostic", "DiagnosticError", "Severity",
    "raise_if_errors", "render_diagnostics",
    "TrackedLock", "LockOrderError", "enable_lock_checking",
    "disable_lock_checking", "check_dispatch_hazard", "lock_violations",
    "preflight", "preflight_transform", "preflight_service",
    "preflight_request", "preflight_config", "check_transform",
]
