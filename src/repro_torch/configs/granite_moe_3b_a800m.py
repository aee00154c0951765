"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (GQA kv=8) d_ff=512/expert,
vocab=49155, MoE 40e top-8 on every layer.  [hf:ibm-granite/granite-3.0-*; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    n_layers=32, d_model=1536, n_heads=24, n_kv=8, head_dim=64,
    d_ff=512, vocab=49155,
    act="swiglu", tie_embeddings=True,
    n_experts=40, top_k=8, moe_period=1, d_ff_expert=512,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-reduced",
        n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=64, vocab=512, n_experts=8, top_k=2, d_ff_expert=64,
        moe_group=64, remat=False, dtype="float32")
