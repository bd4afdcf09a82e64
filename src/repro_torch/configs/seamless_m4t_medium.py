"""seamless-m4t-medium — enc-dec multimodal backbone [arXiv:2308.11596; hf].

12L (enc) + 12L (dec), d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=256206.
Modality frontend is a stub: input_specs() provides precomputed frame
embeddings [B, T_frames, d_model].
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64,
    n_frontend_tokens=4096, norm_eps=1e-5,
    accum_steps=2,
)

SMOKE = ModelConfig(
    name="seamless-m4t-medium-smoke", family="audio",
    n_layers=2, n_enc_layers=2, d_model=96, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=512, head_dim=24,
    n_frontend_tokens=32, norm_eps=1e-5, remat=False,
)
