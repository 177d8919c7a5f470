"""Repo-invariant AST linter — the port's counterpart of the reference's
``check/lint.py``, with rules that say what breaks *this* program.

Rules (all ``FFTB2xx``, suppressible per line with ``# noqa: FFTB2xx``):

* **FFTB201** — a host sync inside *captured* code: a function reachable
  from a captured root — the fused SCF step (``jit_step``, any function
  passed to ``StepGraphs.capture(...)``, as ``dft/scf.py::_jit_scf_loop``
  passes its step body), or a name listed in ``TRACED_ROOTS`` (the plan
  executors that run inside that step).  The syncs: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float()``/``int()``/
  ``bool()`` of a call (a host-only callee such as ``np.float32(...)`` or
  ``math.prod(...)`` excepted), ``torch.cuda.synchronize()``, uploads
  from the host (``torch.from_numpy``, ``torch.as_tensor``/
  ``torch.tensor`` of a non-literal) and item assignment of a Python
  scalar into a subscripted tensor (``x[i] = 1.0`` copies the scalar
  from the host).  Each one makes a CUDA-graph capture fail.  So does a
  collective on several processes under gloo, which copies through host
  memory and waits on the host: a ``dist.*``/``torch.distributed.*``
  call, the grid's ``all_reduce_host`` (its result is a host value), and
  the grid's ``all_reduce``/``replicate``/``reduce_scatter`` (a call on
  a receiver named ``grid``) unless it names its split point with
  ``name=`` — then the grid runs it through ``host_sync`` under that
  name.
  ``host_sync(name, fn, ...)`` ends the graph on purpose and runs ``fn``
  eagerly between two graphs: the rule knows it by name, reports no call
  of it, and does not follow the functions passed to it.
* **FFTB202** — plan construction (``PlanCache.get_or_build``,
  ``fftb.plan_for``, the basis plan getters) inside captured code.
  Plans are fetched before the capture and closed over; a capture
  records the launches, not the Python that chose them.
* **FFTB203** — ``time.time()`` used for *interval* timing (two reads,
  or subtracting a ``time.time()``-assigned variable).  Intervals use
  ``time.perf_counter()``; a single epoch stamp is fine.
* **FFTB204** — a ``perf_counter`` window around torch device work with
  no sync marker in the function (``torch.cuda.synchronize``, an
  event's ``elapsed_time``/``synchronize``, ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``float(...)``, or a ``sync(``/``_sync(``/
  ``time_ms(`` helper): torch returns before the card finishes, so the
  interval would measure the enqueue, not the work.
* **FFTB205** — a bare ``threading.Lock()``/``RLock()`` in ``serve/`` or
  ``core/cache.py``: the serving path uses
  ``repro_torch.check.locks.TrackedLock`` so lock-order checking can see
  it (``check/locks.py`` itself is exempt).

The linter is stdlib-only (``ast``) — it never imports the modules it
checks.  Reachability is a same-module call graph over simple names
(``foo(...)``, ``self.foo(...)``); cross-module reachability is
approximated by ``TRACED_ROOTS`` naming the known captured entry points.
"""
from __future__ import annotations

import ast
import pathlib
import re

from .diagnostics import Diagnostic, error

__all__ = ["lint_paths", "lint_source", "TRACED_ROOTS"]

#: function names treated as captured roots in *any* module, covering the
#: captured surfaces the AST alone cannot see: the fused step's name, and
#: the plan executors (eager and lazy) that the step's H applies run
TRACED_ROOTS: frozenset = frozenset({
    "jit_step",
    "_raw_apply",
    "_raw_apply_lazy",
})

#: plan-construction entry points (FFTB202)
_PLAN_BUILDERS = frozenset({
    "get_or_build", "plan_for", "plans_for_k", "cube_plans",
    "stacked_inverse_plan", "stacked_hamiltonian_plans",
    "stacked_band_tables", "make_planewave_pair",
    "make_stacked_planewave_pair",
})

#: the method whose function argument becomes a captured root
_CAPTURE = "capture"
#: the call that ends a graph on purpose (``dft/graphs.py::host_sync``)
_HOST_SYNC = "host_sync"

#: methods that wait for the card or copy to the host (FFTB201)
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
#: conversions that read a device value on the host when given one
_CONVERSIONS = frozenset({"float", "int", "bool"})
#: callee roots that compute on the host only: converting their result
#: reads no device value
_HOST_ROOTS = frozenset({"np", "numpy", "math", "len"})
#: host→device uploads (FFTB201) when given a non-literal
_UPLOADS = frozenset({"torch.as_tensor", "torch.tensor"})
#: the process-group API: every call is a host sync under gloo (FFTB201)
_DIST_ROOTS = ("dist.", "torch.distributed.")
#: the grid's collectives (FFTB201) — a split point when named (``name=``)
_GRID_COLLECTIVES = frozenset({"all_reduce", "replicate",
                               "reduce_scatter"})

#: files where FFTB205 applies (relative-path substring match)
_LOCK_SCOPE = ("serve/", "core/cache.py")
_LOCK_EXEMPT = ("check/locks.py",)

_NOQA = re.compile(r"#\s*noqa(?::\s*(?P<codes>[A-Z0-9, ]+))?", re.I)


# ----------------------------------------------------------- AST helpers
def _dotted(node) -> str:
    """'torch.cuda.synchronize' for Attribute chains, 'f' for Names, ''
    otherwise."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _call_name(call: ast.Call) -> str:
    return _dotted(call.func)


def _call_attr(call: ast.Call) -> str:
    """The method/function name of a call, even on a call-result chain
    (``torch.linalg.norm(x).item()`` → ``item``)."""
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return _attr_of(_call_name(call))


def _root_of(dotted: str) -> str:
    return dotted.split(".", 1)[0]


def _attr_of(dotted: str) -> str:
    return dotted.rsplit(".", 1)[-1]


def _is_literal(node) -> bool:
    """A constant, or a list/tuple of literals (``torch.tensor([1, 2])``
    builds from Python values known at capture time)."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.operand,
                                                    ast.Constant):
        return True
    if isinstance(node, (ast.List, ast.Tuple)):
        return all(_is_literal(e) for e in node.elts)
    return False


def _is_scalar(node) -> bool:
    """A Python number (``1.0``, ``-2``, ``True``)."""
    if isinstance(node, ast.UnaryOp):
        node = node.operand
    return isinstance(node, ast.Constant) and isinstance(
        node.value, (int, float, complex))


class _FnInfo:
    __slots__ = ("node", "name", "calls", "refs", "is_root")

    def __init__(self, node: ast.AST, name: str):
        self.node = node
        self.name = name
        self.calls: set[str] = set()
        self.refs: set[str] = set()
        self.is_root = False


def _own_statements(fn) -> list[ast.AST]:
    """The function's body nodes, with nested function bodies cut out.

    Nested defs are separate _FnInfo entries; their *names* still count
    as references from the enclosing function.
    """
    out: list[ast.AST] = []
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        out.append(node)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)
    return out


def _host_sync_args(stmts) -> set[int]:
    """ids of the argument nodes of ``host_sync(...)`` calls: the
    functions passed there run eagerly, between graphs."""
    out: set[int] = set()
    for node in stmts:
        if isinstance(node, ast.Call) and _call_attr(node) == _HOST_SYNC:
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                out.update(id(n) for n in ast.walk(arg))
    return out


class _ModuleIndex:
    """All function defs in one module + the captured-reachability set."""

    def __init__(self, tree: ast.Module, extra_roots=()):
        self.fns: list[_FnInfo] = []
        self._by_name: dict[str, list[_FnInfo]] = {}
        roots = TRACED_ROOTS | frozenset(extra_roots)
        self._collect(tree)
        for fn in self.fns:
            if fn.name in roots:
                fn.is_root = True
        # functions passed (by name) to a capture become roots
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == _CAPTURE):
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name):
                    for fn in self._by_name.get(arg.id, ()):
                        fn.is_root = True
        # call/reference edges, not through host_sync's arguments
        for fn in self.fns:
            stmts = _own_statements(fn.node)
            skip = _host_sync_args(stmts)
            for stmt in stmts:
                if id(stmt) in skip:
                    continue
                if isinstance(stmt, ast.Call):
                    callee = _attr_of(_call_name(stmt))
                    if callee and callee != _HOST_SYNC:
                        fn.calls.add(callee)
                elif isinstance(stmt, ast.Name):
                    fn.refs.add(stmt.id)

    def _collect(self, tree) -> None:
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info = _FnInfo(node, node.name)
                self.fns.append(info)
                self._by_name.setdefault(node.name, []).append(info)

    def traced(self) -> set:
        """The set of _FnInfo reachable from any captured root."""
        reached: set[_FnInfo] = set()
        frontier = [fn for fn in self.fns if fn.is_root]
        while frontier:
            fn = frontier.pop()
            if fn in reached:
                continue
            reached.add(fn)
            for name in fn.calls | fn.refs:
                for nxt in self._by_name.get(name, ()):
                    if nxt not in reached:
                        frontier.append(nxt)
        return reached


# ----------------------------------------------------------------- rules
def _noqa_codes(line: str) -> set[str] | None:
    """Codes suppressed on this line; empty set = bare ``# noqa``."""
    m = _NOQA.search(line)
    if not m:
        return None
    codes = m.group("codes")
    if not codes:
        return set()
    return {c.strip().upper() for c in codes.split(",") if c.strip()}


def _suppressed(lines: list[str], lineno: int, code: str) -> bool:
    if not 1 <= lineno <= len(lines):
        return False
    codes = _noqa_codes(lines[lineno - 1])
    if codes is None:
        return False
    return not codes or code in codes


def _host_sync_of(node) -> str:
    """What host sync the node is, or ''."""
    if isinstance(node, ast.Assign):
        if _is_scalar(node.value) and any(
                isinstance(t, ast.Subscript) for t in node.targets):
            return "item assignment of a Python scalar"
        return ""
    if not isinstance(node, ast.Call):
        return ""
    name = _call_name(node)
    attr = _call_attr(node)
    if name in _CONVERSIONS and node.args and isinstance(
            node.args[0], ast.Call):
        inner = _call_name(node.args[0])
        if _root_of(inner) not in _HOST_ROOTS:
            return f"{name}(<device value>)"
        return ""
    if name == "torch.cuda.synchronize":
        return "torch.cuda.synchronize()"
    if attr in _SYNC_METHODS and isinstance(node.func, ast.Attribute) \
            and not name.startswith(("np.", "numpy.")):
        return f".{attr}()"
    if name == "torch.from_numpy":
        return "torch.from_numpy (an upload from the host)"
    if name.startswith(_DIST_ROOTS):
        return f"{name}(...) (a collective: under gloo it waits on the host)"
    if attr == "all_reduce_host":
        return f"{name or attr}(...) (a collective with a host result)"
    if (attr in _GRID_COLLECTIVES and _attr_of(name[:-len(attr) - 1])
            == "grid" and not any(kw.arg == "name" for kw in node.keywords)):
        return (f"{name}(...) without name= (an unnamed collective: name it "
                "to make it a split point)")
    if name in _UPLOADS and node.args and not _is_literal(node.args[0]):
        return f"{name} of a host value (an upload)"
    return ""


def _rule_host_sync(fn: _FnInfo, path: str, lines) -> list[Diagnostic]:
    out = []
    stmts = _own_statements(fn.node)
    skip = _host_sync_args(stmts)
    for node in stmts:
        if id(node) in skip:
            continue
        bad = _host_sync_of(node)
        if bad and not _suppressed(lines, node.lineno, "FFTB201"):
            out.append(error(
                "FFTB201",
                f"host sync {bad} in {fn.name!r}, which is reachable "
                "from a captured root",
                location=f"{path}:{node.lineno}",
                hint="keep the value on the device (build constants "
                     "there), move the sync out of the captured step, or "
                     "route an unavoidable one through host_sync (a grid "
                     "collective: pass its split point's name=)"))
    return out


def _rule_plan_build(fn: _FnInfo, path: str, lines) -> list[Diagnostic]:
    out = []
    for node in _own_statements(fn.node):
        if not isinstance(node, ast.Call):
            continue
        attr = _call_attr(node)
        if attr in _PLAN_BUILDERS and not _suppressed(
                lines, node.lineno, "FFTB202"):
            out.append(error(
                "FFTB202",
                f"plan construction {attr}(...) in {fn.name!r}, which "
                "is reachable from a captured root",
                location=f"{path}:{node.lineno}",
                hint="fetch plans before the capture and close over them "
                     "(as _jit_scf_loop does with its plans and tables)"))
    return out


def _rule_time_time(fn: _FnInfo, path: str, lines) -> list[Diagnostic]:
    calls: list[int] = []
    assigned: set[str] = set()
    subs: list[int] = []
    stmts = _own_statements(fn.node)
    for node in stmts:
        if isinstance(node, ast.Call) and _call_name(node) == "time.time":
            calls.append(node.lineno)
        elif isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call) and _call_name(
                node.value) == "time.time":
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    assigned.add(tgt.id)
    for node in stmts:
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub):
            for side in (node.left, node.right):
                if isinstance(side, ast.Name) and side.id in assigned:
                    subs.append(node.lineno)
    flag_line = None
    if len(calls) >= 2:
        flag_line = sorted(calls)[1]
    elif subs:
        flag_line = min(subs)
    if flag_line is None or _suppressed(lines, flag_line, "FFTB203"):
        return []
    return [error(
        "FFTB203",
        f"time.time() used for interval timing in {fn.name!r}",
        location=f"{path}:{flag_line}",
        hint="use time.perf_counter() for intervals; time.time() is "
             "for epoch stamps only")]


#: calls that wait for the card (FFTB204's sync markers)
_SYNC_MARKERS = frozenset({"synchronize", "elapsed_time", "item", "tolist",
                           "cpu", "numpy", "sync", "_sync", "time_ms"})
#: torch calls that do no device work
_TORCH_HOST = frozenset({"device", "Event", "Stream", "current_stream",
                         "is_available", "device_count", "get_device_name"})


def _rule_dispatch_clock(fn: _FnInfo, path: str, lines) -> list[Diagnostic]:
    pcs: list[int] = []
    has_compute = False
    has_sync = False
    for node in _own_statements(fn.node):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        attr = _call_attr(node)
        if name == "time.perf_counter":
            pcs.append(node.lineno)
        elif attr in _SYNC_MARKERS or name == "float":
            has_sync = True
        elif _root_of(name) == "torch" and attr not in _TORCH_HOST:
            has_compute = True
    if len(pcs) < 2 or not has_compute or has_sync:
        return []
    last = max(pcs)
    if _suppressed(lines, last, "FFTB204"):
        return []
    return [error(
        "FFTB204",
        f"perf_counter window around device work in {fn.name!r} has no "
        "sync before the clock stops",
        location=f"{path}:{last}",
        hint="torch.cuda.synchronize() (or time with CUDA events) inside "
             "the window — otherwise the interval measures the enqueue, "
             "not the work")]


def _rule_bare_lock(tree: ast.Module, path: str, lines) -> list[Diagnostic]:
    if not any(s in path for s in _LOCK_SCOPE) or any(
            s in path for s in _LOCK_EXEMPT):
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name in ("threading.Lock", "threading.RLock", "Lock",
                    "RLock") and not _suppressed(
                lines, node.lineno, "FFTB205"):
            out.append(error(
                "FFTB205",
                f"bare {name}() on the serving path",
                location=f"{path}:{node.lineno}",
                hint="use repro_torch.check.locks.TrackedLock so "
                     "lock-order checking can see this lock"))
    return out


# ------------------------------------------------------------ entry points
def lint_source(source: str, path: str = "<string>",
                extra_roots=()) -> list[Diagnostic]:
    """Lint one module's source text; returns diagnostics."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as err:
        return [error("FFTB201", f"cannot parse: {err}",
                      location=f"{path}:{err.lineno or 0}",
                      hint="fix the syntax error first")]
    lines = source.splitlines()
    index = _ModuleIndex(tree, extra_roots)
    traced = index.traced()
    diags: list[Diagnostic] = []
    for fn in index.fns:
        if fn in traced:
            diags.extend(_rule_host_sync(fn, path, lines))
            diags.extend(_rule_plan_build(fn, path, lines))
        diags.extend(_rule_time_time(fn, path, lines))
        diags.extend(_rule_dispatch_clock(fn, path, lines))
    diags.extend(_rule_bare_lock(tree, path, lines))
    return sorted(diags, key=lambda d: d.location)


def lint_paths(paths, extra_roots=()) -> list[Diagnostic]:
    """Lint every ``.py`` file under the given files/directories."""
    files: list[pathlib.Path] = []
    for raw in paths:
        p = pathlib.Path(raw)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        else:
            files.append(p)
    diags: list[Diagnostic] = []
    for f in files:
        rel = f.as_posix()
        diags.extend(lint_source(f.read_text(), rel, extra_roots))
    return diags
