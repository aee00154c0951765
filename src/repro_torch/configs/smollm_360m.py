"""smollm-360m [dense]: 32L d=960 15H (GQA kv=5) d_ff=2560 vocab=49152,
llama-style.  [hf:HuggingFaceTB/SmolLM-360M; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    n_layers=32, d_model=960, n_heads=15, n_kv=5, head_dim=64,
    d_ff=2560, vocab=49152,
    act="swiglu", tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-reduced",
        n_layers=4, d_model=60, n_heads=3, n_kv=1, head_dim=20,
        d_ff=160, vocab=512, remat=False, dtype="float32")
