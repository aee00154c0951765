"""Build, load and launch the CUDA kernels of ``src/repro_torch/csrc``.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all
started together, into a shared library with a plain C interface
(``-gencode arch=compute_90a,code=sm_90a``), which is loaded with ``ctypes``.
Libraries land in ``build/repro_torch_kernels/<hash of the sources>/`` at the
repository root, so an edited source rebuilds and an unchanged one is
reused.  A missing ``nvcc`` or a failed build raises.

Each wrapper module ``declare``s its C entry points' argument types when it
is imported; ``library`` binds them once, when it loads the library, and
``entry`` hands out the bound function.  Each C entry point takes the
stream last, launches on it and returns ``cudaGetLastError()``; ``launch``
appends the device's current stream, raises when the status is not 0 and
counts the launch in ``LAUNCHES`` (through ``count``, under the module's lock,
since the cluster router launches from several threads at once).  ``SLOTS``
counts, beside it and under the same lock, the work a call site hands its
launches, and ``PATHS`` the launches of a kernel by the path it took
(``take_path`` gives a thread the path of its own last launch).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

__all__ = ["LAUNCHES", "SLOTS", "PATHS", "reset_launches", "count", "count_slots",
           "count_path", "take_path", "build_all",
           "library", "declare", "entry", "launch", "CSRC", "BUILD_ROOT"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Launch counts per kernel: the proof that a run went through the kernels.
LAUNCHES: Dict[str, int] = {"fused_probe_extents": 0, "fused_probe_gather": 0,
                            "fused_rerank": 0, "topk_merge": 0, "rw_hash": 0,
                            "rw_prefix_table": 0, "l1_distance": 0,
                            "l1_distance_rows": 0}

# Work a launch was given, by call site: ``fused_rerank`` counts the
# candidate slots of each launch from ``ops.fused_rerank`` (its ``ids``,
# the padded rung included), so that the valid slots of a window over its
# count is the rerank's fill.
SLOTS: Dict[str, int] = {"fused_rerank": 0}

# Launches by path: ``fused_rerank``'s sliced grid or its windowed
# cooperative launch (``fused_rerank.plan_windows`` picks one a call).
PATHS: Dict[str, Dict[str, int]] = {"fused_rerank": {"sliced": 0, "windowed": 0}}

_LIBS: Dict[str, ctypes.CDLL] = {}
_SIGNATURES: Dict[str, Dict[str, Sequence]] = {}   # library -> entry -> argtypes
_ENTRIES: Dict[Tuple[str, str], Callable[..., int]] = {}
_LOCK = threading.Lock()
_LAST_PATH = threading.local()   # kernel -> (path, detail) of the thread's last launch


def reset_launches() -> None:
    """Zero ``LAUNCHES``, ``SLOTS`` and ``PATHS``."""
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        for name in SLOTS:
            SLOTS[name] = 0
        for paths in PATHS.values():
            for name in paths:
                paths[name] = 0


def count_slots(site: str, n: int) -> None:
    """Add ``n`` to ``SLOTS[site]``, under the lock ``count`` takes."""
    with _LOCK:
        SLOTS[site] += n


def count_path(kernel: str, path: str, detail: Any = 0) -> None:
    """Add one launch of ``kernel`` by ``path`` to ``PATHS``, under the lock,
    and keep ``(path, detail)`` as the calling thread's last launch of it
    (``detail``: what the kernel's wrapper says of the launch)."""
    with _LOCK:
        PATHS[kernel][path] += 1
    setattr(_LAST_PATH, kernel, (path, detail))


def take_path(kernel: str) -> Optional[Tuple[str, Any]]:
    """``(path, detail)`` of the calling thread's last launch of ``kernel``
    since it last asked, or None: each launch is given out once."""
    return _LAST_PATH.__dict__.pop(kernel, None)


def count(kernel: str, n: int = 1) -> None:
    """Add ``n`` launches of ``kernel`` to ``LAUNCHES``, under the module's
    lock: the cluster router's pool threads count at once, and ``+=`` on a
    dict entry is a read, an add and a write."""
    with _LOCK:
        LAUNCHES[kernel] += n


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


def _bind(lib_name: str, names) -> None:
    lib = _LIBS[lib_name]
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = list(_SIGNATURES[lib_name][name])
        fn.restype = ctypes.c_int
        _ENTRIES[(lib_name, name)] = fn


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use), its
    declared entry points bound."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            for lib_name, path in build_all().items():
                if lib_name not in _LIBS:
                    _LIBS[lib_name] = ctypes.CDLL(str(path))
                    _bind(lib_name, _SIGNATURES.get(lib_name, ()))
            lib = _LIBS[name]
        return lib


def declare(lib_name: str, argtypes: Dict[str, Sequence]) -> None:
    """Record the argument types of C entry points of ``csrc/<lib_name>.cu``
    (every one returns an int status).  They are bound when the library
    loads, or at once if it is loaded already."""
    with _LOCK:
        _SIGNATURES.setdefault(lib_name, {}).update(argtypes)
        if lib_name in _LIBS:
            _bind(lib_name, argtypes)


def entry(lib_name: str, name: str):
    """The bound C entry point ``name`` of ``csrc/<lib_name>.cu``."""
    fn = _ENTRIES.get((lib_name, name))
    if fn is None:
        library(lib_name)
        fn = _ENTRIES[(lib_name, name)]
    return fn


def launch(kernel: str, fn, device: int, *args) -> None:
    """Call one C launcher on CUDA device ``device`` with that device's
    current stream appended; raise on a launch error; count the launch.  The
    device is made current only when it is not already.  The stream is read
    as a raw ``cudaStream_t``, without building a ``torch.cuda.Stream``."""
    stream = torch._C._cuda_getCurrentRawStream(device)
    if device == torch.cuda.current_device():
        status = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            status = fn(*args, stream)
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {status}")
    count(kernel)
