"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64 — Mamba2 backbone + shared attention block applied every 6
Mamba layers (weights shared across sites).  [arXiv:2411.15242; unverified]"""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="zamba2-7b", kind="zamba",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, d_ff=14336,
    vocab=32000, ssm_state=64, ssm_head_dim=64, mamba_per_attn=6,
)

REDUCED = ModelConfig(
    name="zamba2-reduced", kind="zamba",
    n_layers=7, d_model=128, n_heads=4, n_kv=4, d_ff=256,
    vocab=512, ssm_state=16, ssm_head_dim=32, mamba_per_attn=3,
    dtype="float32", remat=False, q_block=32,
)
