"""Roofline terms of a dry-run trace: the JAX package's
``launch/roofline.py`` in torch, for one NVIDIA H100 SXM5.

Three terms per (arch x shape x mesh), in seconds, each a rank's:

    compute    = FLOPs               / PEAK_FLOPS
    memory     = bytes accessed      / HBM_BW
    collective = collective bytes    / LINK_BW

The dry-run (``launch/dryrun.py``) counts below DTensor, on the local
shards a rank dispatches, so no division by the rank count is needed.
FLOPs are torch's ``flop_counter`` formulas (matrix products and
convolutions, as XLA's cost analysis counts them, less its elementwise
terms); bytes are every dispatched op's inputs read once and outputs
written once, unfused; collective bytes are the result bytes of every
collective the trace dispatched (for ring implementations within 2x of the
wire bytes, as the reference notes).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

# One NVIDIA H100 SXM5 at its full 700 W power limit.
PEAK_FLOPS = 989e12      # dense bf16 FLOP/s (NVIDIA H100 datasheet; 1,979e12 is with sparsity)
HBM_BW = 3.35e12         # B/s of HBM3 (the same datasheet; PERF.md's bounds use it)
LINK_BW = 450e9          # B/s NVLink 4, one direction (the datasheet's 900 GB/s is both together)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# The collectives a trace dispatches (namespace.op), by the reference's
# kinds: DTensor's functional collectives and the eager ``torch.distributed``
# calls.  A point-to-point exchange counts at its receive, once.
COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_coalesced_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.recv_": "collective-permute",
    "c10d.recv_any_source_": "collective-permute",
}
# Dispatched by collectives but moving no tensor of their own.
NOT_COUNTED = ("_c10d_functional.wait_tensor", "c10d.send", "c10d.barrier",
               "c10d.monitored_barrier_")


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Sum result bytes per collective kind over a trace's records, each a
    ``(namespace.op, result bytes)`` pair; raises for an op of no kind."""
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for op, nbytes in records:
        if op not in COLLECTIVE_OPS:
            raise ValueError(f"collective {op!r} has no kind")
        out[COLLECTIVE_OPS[op]] += int(nbytes)
    return out


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    coll_bytes: float
    coll_breakdown: Dict[str, int]
    peak_bytes_device: float

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def summary(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "flops": self.flops,
            "bytes": self.bytes_accessed,
            "coll_bytes": self.coll_bytes,
            "peak_bytes_device": self.peak_bytes_device,
            "coll_breakdown": {k: v for k, v in self.coll_breakdown.items() if v},
        }


def analyze(trace) -> Roofline:
    """The roofline of a dry-run ``Trace`` (its ``flops``, ``bytes``,
    ``collectives`` records and ``peak_bytes``)."""
    coll = collective_bytes(trace.collectives)
    return Roofline(flops=float(trace.flops), bytes_accessed=float(trace.bytes),
                    coll_bytes=float(sum(coll.values())), coll_breakdown=coll,
                    peak_bytes_device=float(trace.peak_bytes))


def model_flops(cfg, tokens: int, kind: str = "train") -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) for training;
    2*N*D for a forward/decode step."""
    n = cfg.param_count()
    if cfg.n_experts:
        fe = cfg.d_ff_expert or cfg.d_ff
        n_moe_layers = cfg.n_layers // cfg.moe_period
        inactive = n_moe_layers * (cfg.n_experts - cfg.top_k) * 3 * cfg.d_model * fe
        n = n - inactive
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
