"""Build, load and launch the CUDA kernels of ``src/repro_torch/csrc``.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all
started together, into a shared library with a plain C interface
(``-gencode arch=compute_90a,code=sm_90a``), which is loaded with ``ctypes``.
Libraries land in ``build/repro_torch_kernels/<hash of the sources>/`` at the
repository root, so an edited source rebuilds and an unchanged one is
reused.  A missing ``nvcc`` or a failed build raises.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0 and counts the
launch in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

__all__ = ["LAUNCHES", "reset_launches", "build_all", "library", "launch",
           "ptr", "stream_of", "CSRC", "BUILD_ROOT"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Launch counts per kernel: the proof that a run went through the kernels.
LAUNCHES: Dict[str, int] = {"fused_probe": 0, "fused_rerank": 0,
                            "topk_merge": 0, "rw_hash": 0, "l1_distance": 0,
                            "l1_distance_rows": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build_dir() -> Path:
    h = hashlib.sha1()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built, one nvcc each, in parallel.

    Returns {kernel name: library path}.  ptxas's register and shared-memory
    report for each source is kept beside its library as ``<name>.log``.
    """
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out_dir / f"lib{src.stem}.so"
            for src in sorted(CSRC.glob("*.cu"))}
    todo = {name: path for name, path in libs.items() if not path.exists()}
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    try:
        for name, path in todo.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            with open(out_dir / f"{name}.log", "w") as log:
                procs[name] = (subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                    stdout=log, stderr=subprocess.STDOUT), tmp, path)
    finally:
        rcs = {name: proc.wait() for name, (proc, _, _) in procs.items()}
    failed = []
    for name, (_, tmp, path) in procs.items():
        if rcs[name] != 0:
            failed.append(f"{name}: nvcc exit {rcs[name]}\n"
                          + (out_dir / f"{name}.log").read_text()[-4000:])
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            for lib_name, path in build_all().items():
                if lib_name not in _LIBS:
                    _LIBS[lib_name] = ctypes.CDLL(str(path))
            lib = _LIBS[name]
        return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch(kernel: str, fn, *args) -> None:
    """Call one C launcher; raise on a launch error; count the launch."""
    status = fn(*args)
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {status}")
    LAUNCHES[kernel] += 1
