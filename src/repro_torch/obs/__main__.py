"""``python -m repro_torch.obs render <trace_dir>``: span JSONL → Chrome JSON.

  PYTHONPATH=src python -m repro_torch.obs render repro_trace -o trace.json
  PYTHONPATH=src python -m repro_torch.obs render repro_trace -o trace.json \\
      --check --require-cross-process --require-hedge

Open the output in Perfetto (https://ui.perfetto.dev) or chrome://tracing.
``--check`` prints a validation report and exits non-zero on failure —
the CI obs smoke gates on it (schema + a router↔worker span pair joined
by one trace id + the hedge winner/loser pair).
"""
from __future__ import annotations

import argparse
import json
import sys

from .render import check_spans, load_spans, to_chrome
from .trace import trace_dir


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.obs", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    rd = sub.add_parser("render", help="span JSONL dir -> Chrome trace JSON")
    rd.add_argument("dir", nargs="?", default=None,
                    help="trace dir (default: $REPRO_TRACE_DIR or "
                         "./repro_trace)")
    rd.add_argument("-o", "--out", default=None,
                    help="output path (default: <dir>/trace.json)")
    rd.add_argument("--check", action="store_true",
                    help="validate the records; non-zero exit on failure")
    rd.add_argument("--require-cross-process", action="store_true",
                    help="with --check: demand a router<->worker span pair "
                         "joined by one trace id")
    rd.add_argument("--require-hedge", action="store_true",
                    help="with --check: demand a hedge primary/reissue "
                         "pair plus the hedge_win mark")
    args = ap.parse_args(argv)

    src = args.dir or trace_dir()
    spans = load_spans(src)
    out_path = args.out or f"{src.rstrip('/')}/trace.json"
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(to_chrome(spans), f)
    print(f"wrote {len(spans)} spans -> {out_path}")
    if args.check:
        report = check_spans(
            spans, require_cross_process=args.require_cross_process,
            require_hedge=args.require_hedge)
        print(json.dumps(report, indent=1, default=str))
        return 0 if report["ok"] else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
