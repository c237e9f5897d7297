"""smollm-135m [dense] — 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152 — llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="smollm-135m", kind="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv=3, d_ff=1536,
    vocab=49152,
)

REDUCED = ModelConfig(
    name="smollm-135m-reduced", kind="dense",
    n_layers=4, d_model=96, n_heads=3, n_kv=1, d_ff=256,
    vocab=512, dtype="float32", remat=False, q_block=32,
)
