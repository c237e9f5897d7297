"""Host-side token pipeline for LM training — the paper's two-stage
prefetching (Section IV-B) applied to the language-model substrate.

Port of ``repro/data/tokens.py`` on the port's ``PrefetchPipeline``.
Stage "load": the next batch in host memory (synthetic seeded tokens,
standing in for tokenization and host-RAM reads), bit-equal to the
reference's for every frontend.  Stage "transfer": the host-to-device
copy, through a pinned staging buffer issued ``non_blocking`` on the
transfer thread's current stream (the reference's ``jax.device_put`` onto
a sharding); on the host the tensors share the numpy buffers.  Both stages
run in their own threads with bounded queues (``depth``, the prefetch
window) and overlap the training step; ``depth=0`` runs them in sequence.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.core.pipeline import PipelineItem, PrefetchPipeline, Stage
from repro_torch.device import DeviceLike, resolve_device, to_device
from repro_torch.models.lm import ModelConfig

__all__ = ["TokenPipeline"]


@dataclasses.dataclass
class TokenPipeline:
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    depth: int = 2                 # TFP prefetch window (0 = sequential)
    device: DeviceLike = None      # None: cuda:0; "cpu" for the host

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    def _make_host_batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed + step)
        cfg = self.cfg
        if cfg.frontend == "audio_stub":
            emb = rng.standard_normal(
                (self.batch, self.seq, cfg.d_model)).astype(np.float32)
            labels = rng.integers(0, cfg.vocab, (self.batch, self.seq),
                                  dtype=np.int32)
            return {"embeds": emb, "labels": labels}
        if cfg.frontend == "vision_stub":
            nv = cfg.vision_tokens
            toks = rng.integers(0, cfg.vocab, (self.batch, self.seq - nv),
                                dtype=np.int32)
            vis = rng.standard_normal(
                (self.batch, nv, cfg.d_model)).astype(np.float32)
            return {"tokens": toks, "vision_embeds": vis, "labels": toks}
        # zipf-ish synthetic text: heavy-tailed token ids
        z = rng.zipf(1.3, (self.batch, self.seq)).astype(np.int64)
        toks = (z % self.cfg.vocab).astype(np.int32)
        return {"tokens": toks, "labels": toks}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self.batches(10**9)

    def batches(self, num_steps: int, start: int = 0
                ) -> Iterator[Dict[str, torch.Tensor]]:
        """Batches of steps ``start .. start + num_steps - 1``; step ``i``
        draws from ``default_rng(seed + i)``, so a run resumed at a
        checkpoint's step sees the batches an uninterrupted run would.
        (The reference's CLI restarts its stream at step 0 after a
        restore.)"""
        device: torch.device = self.device   # type: ignore[assignment]

        def load(item: PipelineItem) -> PipelineItem:
            item.payload = self._make_host_batch(item.seq)
            return item

        def transfer(item: PipelineItem) -> PipelineItem:
            item.payload = {k: to_device(v, device)
                            for k, v in item.payload.items()}
            return item

        pipe = PrefetchPipeline([Stage("load", load),
                                 Stage("transfer", transfer)],
                                depth=self.depth)
        items = (PipelineItem(seq=i, payload=None)
                 for i in range(start, start + num_steps))
        for item in pipe.run(items):
            yield item.payload
