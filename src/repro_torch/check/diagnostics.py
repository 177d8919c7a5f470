"""The one structured finding type every ``repro_torch.check`` analyzer
emits.

A :class:`Diagnostic` is a stable machine-readable record: a code like
``FFTB110`` (grep-able, never renumbered), a severity, a human message, a
source location (``file:line`` for the linter) or config path (``scf-3d:
nbands`` for preflight) and a fix hint.  Exceptions raised by the library
boundary carry their diagnostics as :class:`DiagnosticError` — a
``ValueError`` subclass, so existing ``except ValueError`` / message-substring
handling keeps working while new callers can switch on ``err.code``.

``CODES`` is the code registry, the same codes as the reference package's
so a finding means the same thing in both; adding a rule means adding one
entry here.
"""
from __future__ import annotations

import dataclasses

#: severity levels, ordered: errors gate, warnings inform
Severity = str
ERROR: Severity = "error"
WARNING: Severity = "warning"

#: code -> one-line description; the single registry behind the README
#: table, the CLI ``codes`` subcommand and the analyzers' self-checks.
CODES: dict[str, str] = {
    # ---------------------------------------------- preflight (FFTB1xx)
    "FFTB101": "transform spec does not parse (bad token, duplicate dim, "
               "missing/extra '->', no transformed dims)",
    "FFTB102": "spec distribution tag references a grid axis the grid "
               "does not have",
    "FFTB103": "spec rank does not match the declared domains' rank",
    "FFTB110": "FFT cube width does not divide over the fft-axis process "
               "count",
    "FFTB111": "sphere bounding-box extents do not divide over the "
               "fft-axis process count",
    "FFTB112": "band count not divisible by the batch-axis process count",
    "FFTB113": "batch/fft grid axes invalid (overlapping, out of range, "
               "or no fft axis)",
    "FFTB114": "k-stacking preconditions not met — the stacked route "
               "falls back to per-k dispatch",
    "FFTB115": "segment sizes violate the batch-axis size_divisor "
               "contract",
    "FFTB116": "sphere diameter outside (0, n]",
    "FFTB117": "padding budget outside [0, 1)",
    "FFTB118": "fused-kernel backend request violates the fused "
               "sphere-pack kernels' line-length or memory constraints",
    "FFTB120": "coefficient array shape does not match the sphere's "
               "packed length",
    "FFTB121": "dtype contract violation (complex coefficients / real "
               "potential expected)",
    "FFTB122": "request band count exceeds the service's max_rows",
    "FFTB130": "plan would not fit the plan-cache byte budget",
    # --------------------------------------------------- lint (FFTB2xx)
    "FFTB201": "host sync inside captured code (reachable from the fused "
               "step / a plan executor it runs): breaks a CUDA-graph "
               "capture",
    "FFTB202": "plan construction / PlanCache build inside captured code "
               "(fetch plans before the capture)",
    "FFTB203": "time.time() used for interval timing (use "
               "time.perf_counter())",
    "FFTB204": "wall-clock window around device work without a "
               "torch.cuda.synchronize/sync before the clock stops",
    "FFTB205": "bare threading.Lock/RLock on the serving path (use "
               "check.locks.TrackedLock)",
    # -------------------------------------------------- locks (FFTB3xx)
    "FFTB301": "lock-order cycle: locks acquired in inconsistent order "
               "across threads",
    "FFTB302": "tracked lock held across a device-dispatch boundary",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One analyzer finding.

    ``location`` is ``"path:line"`` for source findings and a config
    path (``"scenario.nbands"``) for preflight findings; ``hint`` says
    how to fix it, not just what is wrong.
    """

    code: str
    severity: Severity
    message: str
    location: str = ""
    hint: str = ""

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unregistered diagnostic code {self.code!r}")
        if self.severity not in (ERROR, WARNING):
            raise ValueError(f"bad severity {self.severity!r}")

    @property
    def is_error(self) -> bool:
        return self.severity == ERROR

    def render(self) -> str:
        loc = f"{self.location}: " if self.location else ""
        hint = f"  [{self.hint}]" if self.hint else ""
        return f"{loc}{self.code} {self.severity}: {self.message}{hint}"


def error(code: str, message: str, *, location: str = "",
          hint: str = "") -> Diagnostic:
    return Diagnostic(code, ERROR, message, location, hint)


def warning(code: str, message: str, *, location: str = "",
            hint: str = "") -> Diagnostic:
    return Diagnostic(code, WARNING, message, location, hint)


def render_diagnostics(diags) -> str:
    """Multi-line rendering, errors before warnings, stable within."""
    diags = sorted(diags, key=lambda d: (not d.is_error,))
    return "\n".join(d.render() for d in diags)


class DiagnosticError(ValueError):
    """A ``ValueError`` carrying the structured diagnostics behind it.

    The library boundary raises this instead of bare ``ValueError``: the
    message keeps the historical human-readable text (existing handlers
    matching on substrings keep passing), while ``.diagnostics`` /
    ``.code`` expose the machine-readable findings.
    """

    def __init__(self, diagnostics):
        if isinstance(diagnostics, Diagnostic):
            diagnostics = [diagnostics]
        self.diagnostics = list(diagnostics)
        if not self.diagnostics:
            raise ValueError("DiagnosticError needs at least one diagnostic")
        super().__init__("; ".join(
            f"[{d.code}] {d.message}" for d in self.diagnostics))

    @property
    def code(self) -> str:
        """The first (most severe) diagnostic's code."""
        return self.diagnostics[0].code


def raise_if_errors(diags) -> list[Diagnostic]:
    """Raise :class:`DiagnosticError` on any error-severity diagnostic.

    Returns the diagnostics (warnings included) otherwise, so call sites
    can log them.
    """
    diags = list(diags)
    errors = [d for d in diags if d.is_error]
    if errors:
        raise DiagnosticError(errors)
    return diags
