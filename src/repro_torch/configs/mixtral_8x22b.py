"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA.  [arXiv:2401.04088; hf]

The published config has no sliding window (``sliding_window: null``:
full causal attention).  ``FULL``'s ``window=4096`` follows the JAX
reference's registry, which this registry mirrors; the benchmark's
``mixtral-8x22b`` configuration runs the published attention (window 0,
through K8)."""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x22b", kind="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv=8, d_ff=16384,
    vocab=32768, moe_experts=8, moe_top_k=2,
    window=4096,                      # sliding-window attention
    rope_theta=1e6,
)

REDUCED = ModelConfig(
    name="mixtral-8x22b-reduced", kind="moe",
    n_layers=4, d_model=128, n_heads=8, n_kv=2, d_ff=256,
    vocab=512, moe_experts=4, moe_top_k=2, window=64,
    dtype="float32", remat=False, q_block=32,
)
