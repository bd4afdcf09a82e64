"""qwen2.5-14b — dense GQA with QKV bias [hf:Qwen/Qwen2.5 family].

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab_size=152064, head_dim=128,
    qkv_bias=True, rope_theta=1e6, norm_eps=1e-6,
    scan_group=8, accum_steps=4,
)

SMOKE = ModelConfig(
    name="qwen2.5-14b-smoke", family="dense",
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=4,
    d_ff=320, vocab_size=512, head_dim=16,
    qkv_bias=True, rope_theta=1e6, norm_eps=1e-6, remat=False,
)
