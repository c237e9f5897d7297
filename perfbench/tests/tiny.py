"""The benchmark's cell cut to a size the CPU runs in seconds: the same
files, traffic and limits, with the model's widths and depth and the
batch shrunk (never used on the chip)."""
import copy

from perfbench.harness import spec

CELL = "musicgen-medium.clips-30s"


def tiny_cell(dtype: str = "float32"):
    cell = copy.deepcopy(spec.cell(CELL))
    cell["config"]["arch"].update(
        num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
        num_key_value_heads=4, head_dim=16, ffn_dim=128, vocab_size=256,
        dtype=dtype, q_block=32)
    cell["traffic"].update(batch=4, seq=64, microbatches=1)
    return cell
