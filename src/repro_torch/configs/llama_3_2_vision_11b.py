"""llama-3.2-vision-11b — dense backbone with cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; a vision
cross-attention layer after every 5 self-attention layers (8 total).  The
image frontend is stubbed: input_specs() provides patch embeddings
[B, n_patches, d_model].
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128,
    cross_attn_every=5, n_frontend_tokens=1601,
    rope_theta=5e5, norm_eps=1e-5,
    accum_steps=4,
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-11b-smoke", family="vlm",
    n_layers=4, d_model=96, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=24,
    cross_attn_every=2, n_frontend_tokens=16,
    rope_theta=5e5, norm_eps=1e-5, remat=False,
)
