"""The cell's batches, made as the port's ``TokenPipeline`` makes them for
the audio stub: step ``i`` of seed ``s`` draws from
``numpy.random.default_rng(s + i)`` (a frozen copy of its host stage), so
the reference gets the very arrays the program trained on."""
from __future__ import annotations

from typing import Dict

import numpy as np

from .dims import Dims


def host_batch(dims: Dims, batch: int, seq: int, seed: int,
               step: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed + step)
    emb = rng.standard_normal((batch, seq, dims.d)).astype(np.float32)
    labels = rng.integers(0, dims.vocab, (batch, seq), dtype=np.int32)
    return {"embeds": emb, "labels": labels}
