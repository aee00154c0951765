"""seamless-m4t-medium [audio]: enc-dec, 12L encoder + 12L decoder,
d=1024 16H (kv=16) d_ff=4096 vocab=256206.  Audio frontend = STUB
(input_specs supplies precomputed frame embeddings).  [arXiv:2308.11596; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    kind="encdec", n_layers=12, n_enc_layers=12,
    d_model=1024, n_heads=16, n_kv=16, head_dim=64,
    d_ff=4096, vocab=256206,
    act="swiglu", tie_embeddings=True,
    frontend="frames", frontend_len=1024,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-reduced",
        n_layers=3, n_enc_layers=3, d_model=64, n_heads=4, n_kv=4,
        head_dim=16, d_ff=128, vocab=512, frontend_len=16,
        remat=False, dtype="float32")
