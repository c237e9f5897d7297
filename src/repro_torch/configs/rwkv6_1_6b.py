"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536 —
Finch: data-dependent per-channel decay.  [arXiv:2404.05892; unverified]

Heads of size 64; n_kv mirrors n_heads (unused by the RWKV block)."""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="rwkv6-1.6b", kind="rwkv",
    n_layers=24, d_model=2048, n_heads=32, n_kv=32, d_ff=7168,
    vocab=65536, head_dim=64,
)

REDUCED = ModelConfig(
    name="rwkv6-reduced", kind="rwkv",
    n_layers=4, d_model=128, n_heads=4, n_kv=4, d_ff=448,
    vocab=512, head_dim=32, dtype="float32", remat=False, q_block=32,
)
