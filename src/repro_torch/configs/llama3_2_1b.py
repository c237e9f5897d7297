"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3.  [hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="llama3.2-1b", kind="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv=8, d_ff=8192,
    vocab=128256, rope_theta=5e5,
)

REDUCED = ModelConfig(
    name="llama3.2-reduced", kind="dense",
    n_layers=4, d_model=128, n_heads=8, n_kv=2, d_ff=512,
    vocab=512, dtype="float32", remat=False, q_block=32,
)
