"""Unified model configuration covering the 10 assigned architectures."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int               # decoder layers
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # attention
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope_local_theta: float = 0.0   # gemma3 local layers (0 = use rope_theta)
    sliding_window: int = 0         # 0 = full attention
    local_pattern: int = 0          # N local layers per 1 global (gemma3: 5)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # per-expert hidden dim
    n_shared_experts: int = 0
    norm_topk: bool = True

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_ngroups: int = 1

    # hybrid (Zamba2): shared attn block applied every k SSM layers
    hybrid_every: int = 0

    # enc-dec (seamless backbone): encoder depth (0 = decoder-only)
    n_enc_layers: int = 0
    # vision (llama-3.2-vision): cross-attn layer every k self-attn layers
    cross_attn_every: int = 0
    n_frontend_tokens: int = 0      # stubbed modality frontend sequence length

    act: str = "silu"               # silu (swiglu) | gelu (geglu)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    # outer remat group size (0 = flat layer scan).  k>0 nests the layer
    # scan: an outer checkpointed scan over L/k groups × an inner scan of k
    # (individually rematted) blocks — sqrt-L remat: live saved residuals
    # drop from L·|x| to (L/k + k)·|x| for one extra recompute.
    scan_group: int = 0
    # shard the residual-stream sequence dim over "model" (Megatron-style
    # sequence parallelism).  Trades two extra collectives per block for a
    # model-axis-wide reduction in activation memory.
    seq_shard: bool = False
    # microbatch gradient accumulation: the train step scans over
    # `accum_steps` microbatches, accumulating f32 grads — live activation
    # memory drops ~accum_steps× for one extra f32 grad buffer.
    accum_steps: int = 1
    # MoE dispatch implementation: "shard_map" (local partition + expert
    # routing — the paper's partition phase; §Perf) or "gspmd" (naive
    # global dispatch, kept as the reproducible baseline).
    moe_impl: str = "shard_map"

    # serving
    max_cache_len: int = 0          # set per shape at lowering time

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm_headdim

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k+ contexts (bounded state)?"""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        dense_mlp = 3 * d * ff
        if self.is_moe:
            mlp = self.n_experts * 3 * d * self.moe_d_ff \
                + self.n_shared_experts * 3 * d * self.moe_d_ff \
                + d * self.n_experts
        else:
            mlp = dense_mlp
        if self.family == "ssm":
            block = self._ssm_block_params()
            core = self.n_layers * block
        elif self.family == "hybrid":
            n_shared = 1
            core = self.n_layers * self._ssm_block_params() \
                + n_shared * (attn + dense_mlp)
        else:
            core = self.n_layers * (attn + mlp)
            if self.cross_attn_every:
                core += (self.n_layers // self.cross_attn_every) * attn
            if self.n_enc_layers:
                core += self.n_enc_layers * (attn + dense_mlp) \
                    + self.n_layers * attn  # decoder cross-attn
        embed = v * d * (1 if self.tie_embeddings else 2)
        return int(core + embed)

    def _ssm_block_params(self) -> int:
        d, di, st = self.d_model, self.d_inner_ssm, self.ssm_state
        g = self.ssm_ngroups
        in_proj = d * (2 * di + 2 * g * st + self.n_ssm_heads)
        out_proj = di * d
        return in_proj + out_proj + self.ssm_conv * (di + 2 * g * st)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        all_experts = self.n_layers * self.n_experts * 3 * d * self.moe_d_ff
        active = self.n_layers * (self.top_k + self.n_shared_experts) \
            * 3 * d * self.moe_d_ff
        return int(total - all_experts + active)
