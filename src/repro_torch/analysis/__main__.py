"""CLI for the port's invariant lint suite.

  python -m repro_torch.analysis                  # report findings
  python -m repro_torch.analysis --check          # exit 1 on non-baselined findings
  python -m repro_torch.analysis --write-baseline # grandfather current findings
  python -m repro_torch.analysis --dead-code      # reachability report (exit 0)

``--json`` adds ``sanctioned``: every finding an inline allow or the
baseline covers, with the lines of its statement, so that a run on the card
can hold the host syncs it observes against them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .engine import (default_baseline, default_root, diff_against_baseline,
                     iter_source_files, load_baseline, parse_module,
                     run_rules, write_baseline)
from .rules import default_rules


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST invariant lint over src/repro_torch/ (DESIGN.md §11)")
    ap.add_argument("--root", default=None,
                    help="package directory to scan (default: this "
                         "repro_torch package)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: baseline.json beside "
                         "this module)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if any finding is not in the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings to the baseline and exit")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON")
    ap.add_argument("--dead-code", action="store_true",
                    help="emit the import-reachability report instead of "
                         "lint findings (always exits 0)")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root) if args.root else default_root()
    baseline_path = args.baseline or default_baseline()

    if args.dead_code:
        from .deadcode import report_dead_code
        print(report_dead_code(root))
        return 0

    modules = {rel: parse_module(full, rel)
               for full, rel in iter_source_files(root)}
    suppressed = []
    findings = run_rules(default_rules(), modules.values(), suppressed)

    if args.write_baseline:
        write_baseline(baseline_path, findings)
        print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    baseline = load_baseline(baseline_path)
    new, stale = diff_against_baseline(findings, baseline)

    if args.json:
        covered = [(f, "allow") for f in suppressed] + [
            (f, "baseline") for f in findings if f.key() in baseline]
        sanctioned = []
        for f, how in sorted(covered, key=lambda c: (c[0].path, c[0].line)):
            first, last = modules[f.path].statement_span(f.line)
            sanctioned.append({**f.to_json(), "how": how,
                               "lines": [min(first, f.line), max(last, f.line)]})
        print(json.dumps({
            "findings": [f.to_json() for f in findings],
            "new": [f.to_json() for f in new],
            "stale_baseline": sorted(list(k) for k in stale),
            "sanctioned": sanctioned,
        }, indent=1))
    else:
        for f in findings:
            marker = "" if f.key() in baseline else " [NEW]"
            print(f.render() + marker)
        for key in sorted(stale):
            print(f"stale baseline entry (no longer found): {key}")
        print(f"{len(findings)} finding(s), {len(new)} new, "
              f"{len(stale)} stale baseline entr(y/ies), {len(suppressed)} "
              "allowed inline")

    if args.check and new:
        print("FAIL: new findings not covered by the baseline; fix them or "
              "add a justified '# repro: allow[rule-id]'", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
