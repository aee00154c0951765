"""gemma2-27b [dense]: 46L d=4608 32H (GQA kv=16) d_ff=36864 vocab=256000,
alternating local(4096)/global attention, attn-logit softcap 50, final
softcap 30.  [arXiv:2408.00118; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    n_layers=46, d_model=4608, n_heads=32, n_kv=16, head_dim=128,
    d_ff=36864, vocab=256000,
    act="geglu", tie_embeddings=True,
    sliding_window=4096, local_global_period=2,
    attn_softcap=50.0, final_softcap=30.0,
    fsdp=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-reduced",
        n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=256, vocab=512, sliding_window=16, fsdp=False,
        remat=False, dtype="float32")
