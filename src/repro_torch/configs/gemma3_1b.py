"""gemma3-1b — dense, 5:1 local:global attention, 128k rope
[hf:google/gemma-3-1b-pt; unverified].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.  Sliding window 512
on local layers; global layers use rope_theta=1e6, local layers 1e4.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_ff=6912, vocab_size=262144, head_dim=256,
    rope_theta=1e6, rope_local_theta=1e4,
    sliding_window=512, local_pattern=5,
    qk_norm=True, act="gelu", tie_embeddings=True, norm_eps=1e-6,
    accum_steps=2,
)

SMOKE = ModelConfig(
    name="gemma3-1b-smoke", family="dense",
    n_layers=6, d_model=96, n_heads=4, n_kv_heads=1,
    d_ff=256, vocab_size=512, head_dim=32,
    rope_theta=1e6, rope_local_theta=1e4,
    sliding_window=16, local_pattern=5,
    qk_norm=True, act="gelu", tie_embeddings=True, norm_eps=1e-6,
    remat=False,
)
