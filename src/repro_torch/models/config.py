"""Model configuration for the assigned-architecture zoo: the port's own
copy of the JAX package's ``models/config.py`` (every field, derived
property, ``sub_block_kinds()`` and ``param_count()``), so that the port
imports nothing of ``repro``.

One frozen dataclass drives every family: dense decoder (llama/gemma),
MoE (llama4/granite), VLM backbone (phi-3-vision), encoder-decoder
(seamless-m4t), hybrid Mamba+shared-attention (zamba2) and pure SSM
(mamba2).  ``src/repro_torch/configs/<arch>.py`` instantiates the exact
assignment-sheet numbers.

``remat`` and ``remat_policy`` checkpoint the stacks' layer groups while
grad is enabled; the training launcher takes ``opt_moment_dtype``;
``fsdp`` adds the data axes to the sharding rules (``models.sharding``).
``scan_unroll`` shapes the JAX package's compiled programs; the port does
not read it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _ceil_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    # block structure
    kind: str = "decoder"           # decoder | encdec | hybrid | ssm
    n_enc_layers: int = 0           # encdec only
    act: str = "swiglu"             # swiglu | geglu
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    # attention variants
    sliding_window: int = 0         # 0 = all-global
    local_global_period: int = 0    # gemma2: 2 -> alternate local/global
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    # MoE
    n_experts: int = 0
    top_k: int = 1
    moe_period: int = 1             # MoE every k-th layer (1 = every layer)
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 1024           # tokens per routing group
    router_aux_weight: float = 0.01
    # modality frontend (STUB: input_specs supplies precomputed embeddings)
    frontend: str = ""              # '' | 'patch' | 'frames'
    frontend_len: int = 64          # frontend positions prepended at train/prefill
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    ssm_groups: int = 1
    hybrid_attn_period: int = 0     # zamba: shared attn block every k layers
    # training / numerics
    attn_chunk: int = 0             # >0: block-causal chunked (flash-style)
                                    # attention for training forward
    remat: bool = True
    scan_unroll: bool = False   # fully unroll layer scans (dry-run accounting:
                                # XLA cost_analysis counts while bodies ONCE;
                                # unrolling makes FLOPs/bytes/collectives exact)
    remat_policy: str = "full"      # 'full' | 'dots' (save dot outputs:
                                    # avoids re-all-gathering fsdp params
                                    # during backward recompute)
    dtype: str = "bfloat16"
    loss_dtype: str = ""            # logits dtype; '' -> follow cfg.dtype
    fsdp: bool = False              # shard params over the data axes too
    opt_moment_dtype: str = "float32"

    # ---- derived ----
    @property
    def resolved_loss_dtype(self) -> str:
        return self.loss_dtype or self.dtype

    @property
    def vocab_padded(self) -> int:
        return _ceil_to(self.vocab, 128)

    @property
    def n_experts_padded(self) -> int:
        return _ceil_to(self.n_experts, 16) if self.n_experts else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def group_size(self) -> int:
        """Layers per scan group (llama4 interleaves dense/MoE; gemma2
        alternates local/global)."""
        g = 1
        if self.n_experts and self.moe_period > 1:
            g = self.moe_period
        if self.local_global_period > 1:
            g = max(g, self.local_global_period)
        return g

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.group_size == 0, (self.name, self.n_layers, self.group_size)
        return self.n_layers // self.group_size

    def sub_block_kinds(self) -> Tuple[str, ...]:
        """Static description of each position inside a scan group.

        'attn'       — global attention + dense MLP
        'attn_local' — sliding-window attention + dense MLP
        'moe'        — global attention + MoE FFN
        'mamba'      — Mamba-2 SSD block
        """
        if self.kind in ("ssm",):
            return ("mamba",)
        if self.kind == "hybrid":
            return ("mamba",)  # shared attention handled outside the scan
        kinds = []
        for j in range(self.group_size):
            local = self.local_global_period > 1 and (j % self.local_global_period == 0)
            moe = self.n_experts > 0 and ((j + 1) % self.moe_period == 0)
            if moe:
                kinds.append("moe")
            elif local:
                kinds.append("attn_local")
            else:
                kinds.append("attn")
        return tuple(kinds)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.head_dim
        attn = d * hd * (self.n_heads * 2 + self.n_kv * 2)
        dense = 3 * d * self.d_ff
        moe = 0
        if self.n_experts:
            fe = self.d_ff_expert or self.d_ff
            moe = self.n_experts * 3 * d * fe + d * self.n_experts
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.kind == "ssm" or self.kind == "hybrid":
            din = self.d_inner
            per = d * din * 2 + din * d + 2 * d * self.ssm_groups * self.ssm_state \
                + d * self.ssm_heads + 3 * self.ssm_heads
            total += self.n_layers * per
            if self.kind == "hybrid":
                total += attn + dense  # one shared block
            return total
        n_moe = self.n_layers // self.moe_period if self.n_experts else 0
        n_dense = self.n_layers - n_moe
        total += self.n_layers * attn + n_dense * dense + n_moe * moe
        if self.kind == "encdec":
            total += self.n_enc_layers * (attn + dense) + self.n_layers * attn  # cross-attn
        return total
