"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) — MoE 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (MHA kv=16) per-expert d_ff=1408 vocab=163840.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=163840, head_dim=128,
    n_experts=64, top_k=6, moe_d_ff=1408, n_shared_experts=2,
    norm_topk=True, rope_theta=5e4, norm_eps=1e-5,
    scan_group=8, accum_steps=4,
)

SMOKE = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke", family="moe",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, head_dim=24,
    n_experts=8, top_k=2, moe_d_ff=64, n_shared_experts=1,
    norm_topk=True, rope_theta=5e4, norm_eps=1e-5, remat=False,
)
