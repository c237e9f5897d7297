"""Roofline terms of a dry-run cell at the H100's constants (port of
``repro/launch/analysis.py``).

The dry-run counts per-rank quantities (``launch/costmodel.py``), so

    compute    term = flops_per_rank / peak bf16 FLOP/s
    memory     term = bytes_per_rank / HBM bytes/s
    collective term = collective operand bytes per rank / NVLink bytes/s

Constants: one NVIDIA H100 80GB HBM3 (SXM, the card ``nvidia-smi`` names),
from NVIDIA's data sheet at the full 700 W power limit: 989 TFLOP/s dense
bf16, 3.35 TB/s HBM, 450 GB/s NVLink each way.  The collective term
assumes every collective byte crosses NVLink (one host of eight cards);
across hosts the network is slower.  ``CollectiveBytes`` sums the operand
bytes of every collective a step issues, by kind, as the reference parses
them out of the compiled HLO.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict

from torch.utils._python_dispatch import TorchDispatchMode

from .costmodel import is_collective, local_nbytes

__all__ = ["HW", "Roofline", "CollectiveBytes", "model_flops_total",
           "FIT_BYTES"]

PEAK_FLOPS = 989e12          # dense bf16 tensor cores
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # NVLink bytes/s each way
HW = {"card": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0,
      "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "link_bw": LINK_BW}
FIT_BYTES = 80 * 10**9       # the card's 80 GB

_KINDS = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"), ("broadcast", "broadcast"))


def _kind(opname: str) -> str:
    return next((k for key, k in _KINDS if key in opname), opname)


class CollectiveBytes(TorchDispatchMode):
    """Operand bytes (the rank's input) of every collective seen, by kind
    (``all-gather``, ``reduce-scatter``, ``all-reduce``, ``all-to-all``,
    ``broadcast``), and their count."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, int] = Counter()
        self.count: Dict[str, int] = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if is_collective(func):
            kind = _kind(func._opname)
            self.bytes[kind] += local_nbytes(args[0])
            self.count[kind] += 1
        return func(*args, **kwargs)

    def totals(self) -> Dict[str, int]:
        out = dict(self.bytes)
        out["total"] = sum(self.bytes.values())
        return out


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-rank counted FLOPs
    hbm_bytes: float             # per-rank counted bytes
    coll_bytes: float            # per-rank collective operand bytes
    model_flops: float           # 6·N_active·tokens / ranks ("useful")

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / bound time (1.0 = at the roofline)."""
        t_useful = self.model_flops / PEAK_FLOPS
        return t_useful / self.t_bound if self.t_bound else 0.0

    def as_dict(self) -> Dict[str, object]:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "coll_bytes_per_chip": self.coll_bytes,
            "model_flops_per_chip": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_total(cfg, shape) -> float:
    """6·N_active·tokens for train; 2·N_active·tokens for prefill; decode
    one token a sequence."""
    from ..models import active_param_count
    n_active = active_param_count(cfg)
    if shape.step == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.step == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch
