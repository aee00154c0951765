"""mamba2-370m [ssm]: 48L d=1024, attn-free, ssm_state=128, SSD (state-space
duality), vocab=50280.  [arXiv:2405.21060; unverified]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    kind="ssm", n_layers=48, d_model=1024, n_heads=0, n_kv=0, head_dim=0,
    d_ff=0, vocab=50280,
    tie_embeddings=True,
    ssm_state=128, ssm_expand=2, ssm_headdim=64,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-reduced",
        n_layers=4, d_model=64, vocab=512, ssm_state=16, ssm_headdim=16,
        ssm_chunk=8, remat=False, dtype="float32")
