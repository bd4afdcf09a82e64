"""yi-34b — dense llama-arch GQA [arXiv:2403.04652; hf].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000, head_dim=128,
    rope_theta=5e6, norm_eps=1e-5,
    scan_group=10, accum_steps=4,
)

SMOKE = ModelConfig(
    name="yi-34b-smoke", family="dense",
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=352, vocab_size=512, head_dim=16,
    rope_theta=5e6, norm_eps=1e-5, remat=False,
)
