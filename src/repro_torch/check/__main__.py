"""CLI for the port's static analyzers (the reference's check CLI, with
the same subcommands and exit statuses).

Usage::

    python -m repro_torch.check lint src/repro_torch [more paths...]
    python -m repro_torch.check preflight benchmarks/baseline.json
    python -m repro_torch.check preflight config.json --scenario scf-3d
    python -m repro_torch.check codes

``lint`` reads source with the stdlib ``ast`` and imports nothing it
checks; ``preflight`` imports ``repro_torch.core`` but never touches a
device (8-process scenarios audit from any box; the records' reference
backend names are translated by ``preflight_scenario``).  Exit status: 0
clean, 1 on any error-severity diagnostic, 2 on usage errors.  Warnings
print but do not fail the run.
"""
from __future__ import annotations

import argparse
import json
import sys

from .diagnostics import CODES, render_diagnostics


def _cmd_lint(args) -> int:
    from .lint import lint_paths
    diags = lint_paths(args.paths, extra_roots=args.traced_root)
    if diags:
        print(render_diagnostics(diags))
    errors = [d for d in diags if d.is_error]
    print(f"repro_torch.check lint: {len(errors)} error(s), "
          f"{len(diags) - len(errors)} warning(s)")
    return 1 if errors else 0


def _cmd_preflight(args) -> int:
    from .preflight import preflight_config, preflight_scenario
    with open(args.config) as fh:
        data = json.load(fh)
    diags = []
    if isinstance(data, dict) and "scenarios" in data:
        items = data["scenarios"].items()
        if args.scenario:
            missing = [s for s in args.scenario
                       if s not in data["scenarios"]]
            if missing:
                print(f"unknown scenario(s) {missing}; available: "
                      f"{sorted(data['scenarios'])}", file=sys.stderr)
                return 2
            items = [(s, data["scenarios"][s]) for s in args.scenario]
        for name, record in items:
            diags.extend(preflight_scenario(name, record))
        audited = len(list(items))
    else:
        diags.extend(preflight_config(data, name=args.config))
        audited = 1
    if diags:
        print(render_diagnostics(diags))
    errors = [d for d in diags if d.is_error]
    print(f"repro_torch.check preflight: {audited} config(s) audited, "
          f"{len(errors)} error(s), {len(diags) - len(errors)} "
          "warning(s)")
    return 1 if errors else 0


def _cmd_codes(_args) -> int:
    width = max(len(c) for c in CODES)
    for code, desc in sorted(CODES.items()):
        print(f"{code:<{width}}  {desc}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="FFTB static analysis: preflight config "
                    "diagnostics, repo-invariant lint, diagnostic "
                    "code registry.")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_lint = sub.add_parser("lint", help="AST-lint repo source")
    p_lint.add_argument("paths", nargs="+",
                        help="files or directories to lint")
    p_lint.add_argument("--traced-root", action="append", default=[],
                        help="extra function name treated as a captured "
                             "root (repeatable)")
    p_lint.set_defaults(fn=_cmd_lint)

    p_pf = sub.add_parser(
        "preflight", help="audit a config / baseline scenario file")
    p_pf.add_argument("config",
                      help="JSON config dict or benchmarks baseline "
                           "file with a 'scenarios' table")
    p_pf.add_argument("--scenario", action="append", default=[],
                      help="audit only this scenario (repeatable)")
    p_pf.set_defaults(fn=_cmd_preflight)

    p_codes = sub.add_parser("codes", help="print the code registry")
    p_codes.set_defaults(fn=_cmd_codes)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
