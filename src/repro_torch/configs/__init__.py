"""Assigned-architecture registry: ``get_config(arch_id)``, the port's
copy of the JAX package's ``configs/`` (the same numbers).

One module per architecture with the exact assignment-sheet numbers; each
exposes ``CONFIG`` (full scale) and ``reduced()`` (CPU smoke-test scale,
same family/topology, tiny dims).
"""
from __future__ import annotations

import importlib

ARCHS = (
    "llama4_maverick_400b_a17b",
    "granite_moe_3b_a800m",
    "phi_3_vision_4_2b",
    "gemma_7b",
    "gemma_2b",
    "smollm_360m",
    "gemma2_27b",
    "seamless_m4t_medium",
    "zamba2_1_2b",
    "mamba2_370m",
)

def canonical(arch: str) -> str:
    norm = arch.replace("-", "_").replace(".", "_")
    return norm if norm in ARCHS else arch


def get_config(arch: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.CONFIG


def get_reduced(arch: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.reduced()
