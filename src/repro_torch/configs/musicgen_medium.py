"""musicgen-medium [audio] — 48L d_model=1536 24H (kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

The EnCodec frontend is a stub (precomputed frame embeddings); GELU
(non-gated) MLP, d_ff = 4·d_model."""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="musicgen-medium", kind="dense",
    n_layers=48, d_model=1536, n_heads=24, n_kv=24, d_ff=6144,
    vocab=2048, mlp="gelu", frontend="audio_stub",
)

REDUCED = ModelConfig(
    name="musicgen-reduced", kind="dense",
    n_layers=4, d_model=128, n_heads=4, n_kv=4, d_ff=512,
    vocab=256, mlp="gelu", frontend="audio_stub",
    dtype="float32", remat=False, q_block=32,
)
