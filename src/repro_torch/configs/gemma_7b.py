"""gemma-7b [dense]: 28L d=3072 16H (GQA kv=16) d_ff=24576 vocab=256000,
GeGLU, head_dim=256.  [arXiv:2403.08295; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    n_layers=28, d_model=3072, n_heads=16, n_kv=16, head_dim=256,
    d_ff=24576, vocab=256000,
    act="geglu", tie_embeddings=True,
    fsdp=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-reduced",
        n_layers=3, d_model=64, n_heads=4, n_kv=4, head_dim=32,
        d_ff=256, vocab=512, fsdp=False, remat=False, dtype="float32")
