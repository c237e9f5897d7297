"""Token-id batches as the port's ``TokenPipeline`` makes them with
``zipf_exponent`` set (a frozen copy of its host stage): step ``i`` of seed
``s`` draws one uniform a token from ``numpy.random.default_rng(s + i)``
and inverts Zipf's cumulative law over the whole vocabulary; the rank is
mapped to an id by a permutation drawn once from ``default_rng(s)``.  The
labels are the tokens (the loss shifts them).  So the reference gets the
very arrays the program trained on."""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np


@functools.lru_cache(maxsize=4)
def _law(vocab: int, exponent: float, seed: int
         ) -> Tuple[np.ndarray, np.ndarray]:
    weight = np.arange(1, vocab + 1, dtype=np.float64) ** (-exponent)
    cdf = np.cumsum(weight) / weight.sum()
    cdf[-1] = 1.0
    ids = np.random.default_rng(seed).permutation(vocab).astype(np.int32)
    return cdf, ids


def host_batch(vocab: int, exponent: float, batch: int, seq: int,
               seed: int, step: int) -> Dict[str, np.ndarray]:
    cdf, ids = _law(vocab, float(exponent), int(seed))
    rng = np.random.default_rng(seed + step)
    toks = ids[np.searchsorted(cdf, rng.random((batch, seq)), side="right")]
    return {"tokens": toks, "labels": toks}
