"""llama4-maverick-400b-a17b [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128e top-1, early fusion.  MoE on every 2nd layer
(interleave reproduces the 400B-total / 17B-active budget with 128 experts
at d_ff_expert=8192).  [hf:meta-llama/Llama-4-*; unverified]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, head_dim=128,
    d_ff=8192, vocab=202048,
    act="swiglu", rope_theta=500000.0, tie_embeddings=False,
    n_experts=128, top_k=1, moe_period=2, d_ff_expert=8192,
    frontend="patch", frontend_len=64,     # early fusion: patch embeds STUB
    fsdp=True, opt_moment_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name=CONFIG.name + "-reduced",
        n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=512, n_experts=8, d_ff_expert=128,
        frontend_len=4, moe_group=64, fsdp=False,
        opt_moment_dtype="float32", remat=False, dtype="float32")
