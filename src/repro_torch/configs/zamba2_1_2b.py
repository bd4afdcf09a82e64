"""zamba2-1.2b — hybrid Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf].

38 Mamba2 layers, d_model=2048, ssm_state=64; one shared transformer block
(32H MHA, d_ff=8192) invoked every 6 SSM layers.  vocab 32000.
Simplifications vs release (DESIGN.md): no per-invocation LoRA, shared
block input is the running stream (no embedding concat).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssm_ngroups=1,
    hybrid_every=6, tie_embeddings=True, norm_eps=1e-5,
    accum_steps=2,
)

SMOKE = ModelConfig(
    name="zamba2-1.2b-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, head_dim=16,
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_conv=4, ssm_ngroups=1,
    hybrid_every=2, tie_embeddings=True, norm_eps=1e-5, remat=False,
)
