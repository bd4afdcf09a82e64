"""qwen3-moe-30b-a3b — MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4) per-expert d_ff=768 vocab=151936, QK-norm.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128,
    n_experts=128, top_k=8, moe_d_ff=768,
    qk_norm=True, norm_topk=True, rope_theta=1e6, norm_eps=1e-6,
    scan_group=8, accum_steps=4,
)

SMOKE = ModelConfig(
    name="qwen3-moe-30b-a3b-smoke", family="moe",
    n_layers=2, d_model=96, n_heads=8, n_kv_heads=2,
    d_ff=96, vocab_size=512, head_dim=16,
    n_experts=8, top_k=2, moe_d_ff=48,
    qk_norm=True, norm_topk=True, rope_theta=1e6, norm_eps=1e-6,
    remat=False,
)
