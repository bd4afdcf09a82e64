"""qwen2-1.5b — dense GQA with QKV bias [arXiv:2407.10671; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True, norm_eps=1e-6,
    accum_steps=4,
)

SMOKE = ModelConfig(
    name="qwen2-1.5b-smoke", family="dense",
    n_layers=3, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=16,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True, norm_eps=1e-6,
    remat=False,
)
