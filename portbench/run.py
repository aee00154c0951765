"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is found by name in BENCHMARK.json;
its configuration, traffic and metrics in the files beside it.  The run
needs as many CUDA cards as the cell asks for (never the CPU), and is
refused on fewer.  It builds or loads the port's kernels in the checkout,
makes its inputs on the card from the seed, measures for ``--seconds``,
checks a drawn sample of the answers against the plain reference, and
prints one JSON object as the last line of standard output.  The numbers
compared, each beside its limit, are the last lines of standard error and
the result's last key.

A cell on one card serves the engine in this process.  A cell on R > 1
cards needs a configuration whose ``index`` block declares ``"row_shards":
R``: it runs one process a card under NCCL (``harness/ranks.py``), the
row-sharded index served in lockstep (``harness/cell.run_sharded``), and
this process prints rank 0's result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(names=None) -> list:
    """Top-level names of loaded modules (or of ``names``) that are JAX or
    the JAX package, compared whole (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        log(f"portbench: the program is missing ({ROOT / 'src' / 'repro_torch'})")
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from portbench.harness import program, spec
    cell = spec.load_cell(ROOT, args.workload)
    shards = program.row_shards(cell.config)
    if shards != cell.chips:
        log(f"portbench: {args.workload} asks for {cell.chips} cards and its configuration "
            f"declares {shards} row shards; a cell on R cards serves R row shards")
        return 2

    import torch
    torch.set_num_threads(1)          # one process, few threads: the host's work is serial
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        log(f"portbench: {args.workload} needs {cell.chips} card{'s' * (cell.chips > 1)}, "
            f"{found} found" + ("" if found else ": no CUDA device is available; the "
                                "benchmark never runs on the CPU"))
        return 2

    from portbench.harness import cell as cell_run
    if cell.chips == 1:
        result = cell_run.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              T_START, log)
    else:
        from portbench.harness.ranks import RankFailure
        try:
            result = cell_run.run_sharded(cell, args.seed, args.seconds, bool(args.trace),
                                          "nccl", "cuda", T_START, log, FORBIDDEN)
        except RankFailure as err:
            log(f"portbench: {args.workload}: {err}")
            return 3
    found = forbidden_modules()
    if found:
        log(f"portbench: JAX or the JAX package was loaded: {', '.join(found)}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
