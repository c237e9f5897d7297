"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT + InternLM2.  [arXiv:2404.16821; hf]

The InternViT frontend is a stub (256 precomputed patch embeddings per
sample prepended to the text tokens); vocab is padded to a multiple of 128
and the padded logits are masked."""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="internvl2-1b", kind="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv=2, d_ff=4864,
    vocab=151655, frontend="vision_stub", vision_tokens=256,
)

REDUCED = ModelConfig(
    name="internvl2-reduced", kind="dense",
    n_layers=4, d_model=128, n_heads=4, n_kv=2, d_ff=320,
    vocab=512, frontend="vision_stub", vision_tokens=8,
    dtype="float32", remat=False, q_block=32,
)
