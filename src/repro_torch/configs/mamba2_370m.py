"""mamba2-370m — pure SSD (state-space duality) stack, attention-free
[arXiv:2405.21060; unverified].

48L d_model=1024 ssm_state=128 vocab=50280 (d_ff=0: no MLP — Mamba2 blocks
interleave nothing).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=50280, head_dim=64,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssm_ngroups=1,
    tie_embeddings=True, norm_eps=1e-5,
    accum_steps=2,
)

SMOKE = ModelConfig(
    name="mamba2-370m-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=512, head_dim=16,
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_conv=4, ssm_ngroups=1,
    tie_embeddings=True, norm_eps=1e-5, remat=False,
)
