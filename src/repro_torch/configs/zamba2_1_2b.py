"""zamba2-1.2b [hybrid]: 38L Mamba2 backbone d=2048 + single weight-shared
attention block (32H kv=32 d_ff=8192) applied every 6 layers (Zamba trick);
ssm_state=64, vocab=32000.  [arXiv:2411.15242; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    kind="hybrid", n_layers=38, d_model=2048, n_heads=32, n_kv=32,
    head_dim=64, d_ff=8192, vocab=32000,
    act="swiglu", tie_embeddings=True,
    ssm_state=64, ssm_expand=2, ssm_headdim=64,
    hybrid_attn_period=6,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-reduced",
        n_layers=5, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=128, vocab=512, ssm_state=16, ssm_headdim=16,
        hybrid_attn_period=2, ssm_chunk=8, remat=False, dtype="float32")
