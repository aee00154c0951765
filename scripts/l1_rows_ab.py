"""Time two builds of ``csrc/l1_distance.cu``'s per-row kernel on one card,
in turns: an earlier checkout's (PARENT) and this checkout's.

    python3 scripts/l1_rows_ab.py PARENT_ROOT [--rounds 2]

PARENT_ROOT is an unpacked earlier commit (``git archive <commit> | tar -x
-C <dir>``) whose ``l1_rows_*`` entry points take (queries, rows, out, Q, C,
m, stream).  Each source is built by its own ``nvcc`` into ``build/`` at this
checkout's root.  At each shape (the smoke's served batch, 64 x 4,096 x 128
in int32, int16 and bfloat16, and SRS's 256 x 512 x 128 int32; coordinates
drawn in [0, 510] from a seed) both kernels must equal the plain version;
then each is timed by one CUDA event pair around 50 back-to-back launches of
its C entry point alone, / 50, in the order parent, change, change, parent,
for ``--rounds`` rounds.  Prints the card (``nvidia-smi``) and one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (("served_int32", 64, 4096, 128, torch.int32),
          ("served_int16", 64, 4096, 128, torch.int16),
          ("served_bfloat16", 64, 4096, 128, torch.bfloat16),
          ("srs_int32", 256, 512, 128, torch.int32))
CALLS, HBM_BYTES_PER_S = 50, 3.35e12
SUFFIX = {torch.int32: "i32", torch.int16: "i16", torch.bfloat16: "bf16"}


def build(src: Path, name: str) -> ctypes.CDLL:
    out = ROOT / "build" / "l1_rows_ab" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(out),
                    str(src)], check=True)
    return ctypes.CDLL(str(out))


def amortised_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(CALLS):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / CALLS


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("l1_rows_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import l1_distance as kl1

    libs = {"parent": build(args.parent / "src/repro_torch/csrc/l1_distance.cu", "parent"),
            "change": build(ROOT / "src/repro_torch/csrc/l1_distance.cu", "change")}
    card = torch.device("cuda")
    gen = torch.Generator(device=card).manual_seed(28)
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for name, q, c, m, dtype in SHAPES:
        qd = torch.randint(0, 511, (q, m), generator=gen, device=card).to(dtype)
        rd = torch.randint(0, 511, (q, c, m), generator=gen, device=card).to(dtype)
        want = kl1.l1_distance_rows_plain(qd, rd)
        plan = kl1.plan_rows(dtype, m, c, q, rd.data_ptr(), qd.data_ptr())
        calls = {}
        for which, lib in libs.items():
            out = torch.empty_like(want)
            fn = getattr(lib, f"l1_rows_{SUFFIX[dtype]}")
            extra = () if which == "parent" else (plan.slots, plan.seg, plan.tile, plan.stage)
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * (3 + len(extra))
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            argv = (qd.data_ptr(), rd.data_ptr(), out.data_ptr(), q, c, m, *extra, stream)
            if fn(*argv) != 0 or not torch.equal(out, want):
                raise AssertionError(f"{which} l1_rows != plain at {name}")
            calls[which] = (lambda f=fn, a=argv: f(*a))
        times = {"parent": [], "change": []}
        for _ in range(args.rounds):
            for which in ("parent", "change", "change", "parent"):
                times[which].append(amortised_ms(calls[which]))
        nbytes = (rd.numel() + qd.numel()) * rd.element_size() + want.numel() * 4
        result[name] = {"shape": [q, c, m], "plan": plan._asdict(), **times,
                        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())
    print(json.dumps({"l1_rows_ab": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
