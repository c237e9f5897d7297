"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned nemotron.  [arXiv:2407.14679; hf]"""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="minitron-4b", kind="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv=8, d_ff=9216,
    vocab=256000,
)

REDUCED = ModelConfig(
    name="minitron-reduced", kind="dense",
    n_layers=4, d_model=128, n_heads=4, n_kv=2, d_ff=384,
    vocab=1024, dtype="float32", remat=False, q_block=32,
)
