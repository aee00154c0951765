"""phi-3-vision-4.2b [vlm]: 32L d=3072 32H (kv=32, MHA) d_ff=8192
vocab=32064; phi3-mini backbone + CLIP frontend (STUB: input_specs supplies
precomputed patch embeddings).  [hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    n_layers=32, d_model=3072, n_heads=32, n_kv=32, head_dim=96,
    d_ff=8192, vocab=32064,
    act="swiglu", tie_embeddings=False,
    frontend="patch", frontend_len=576,   # 24x24 CLIP patches
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-reduced",
        n_layers=4, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=128, vocab=512, frontend_len=8, remat=False, dtype="float32")
