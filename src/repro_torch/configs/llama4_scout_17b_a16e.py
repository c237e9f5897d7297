"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="llama4-scout-17b-a16e", kind="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=8192,
    vocab=202048, moe_experts=16, moe_top_k=1,
    rope_theta=5e5,
)

REDUCED = ModelConfig(
    name="llama4-scout-reduced", kind="moe",
    n_layers=4, d_model=128, n_heads=8, n_kv=2, d_ff=192,
    vocab=640, moe_experts=4, moe_top_k=1,
    dtype="float32", remat=False, q_block=32,
)
