"""gemma-2b [dense]: 18L d=2048 8H (MQA kv=1) d_ff=16384 vocab=256000,
GeGLU, head_dim=256.  [arXiv:2403.08295; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    n_layers=18, d_model=2048, n_heads=8, n_kv=1, head_dim=256,
    d_ff=16384, vocab=256000,
    act="geglu", tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-reduced",
        n_layers=3, d_model=64, n_heads=4, n_kv=1, head_dim=32,
        d_ff=256, vocab=512, remat=False, dtype="float32")
