"""smollm-360m [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152 — llama-arch small.  [hf:HuggingFaceTB/SmolLM-360M; hf]"""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="smollm-360m", kind="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv=5, d_ff=2560,
    vocab=49152,
)

REDUCED = ModelConfig(
    name="smollm-360m-reduced", kind="dense",
    n_layers=4, d_model=128, n_heads=4, n_kv=2, d_ff=320,
    vocab=512, dtype="float32", remat=False, q_block=32,
)
