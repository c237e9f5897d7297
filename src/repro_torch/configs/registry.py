"""Architecture registry: ``--arch <id>`` resolution for the launchers and
tests (port of ``repro/configs/registry.py``), with the input shapes'
names re-exported and ``all_cells`` over every (arch, shape) cell."""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.models.lm import ModelConfig

from . import (internvl2_1b, llama3_2_1b, llama4_scout_17b_a16e,
               minitron_4b, mixtral_8x22b, musicgen_medium, rwkv6_1_6b,
               smollm_135m, smollm_360m, zamba2_7b)
from .shapes import SHAPES, ShapeSpec, cell_applicable, input_specs

__all__ = ["ARCHS", "get_arch", "SHAPES", "ShapeSpec", "cell_applicable",
           "input_specs", "all_cells"]

_MODULES = {
    "mixtral-8x22b": mixtral_8x22b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "zamba2-7b": zamba2_7b,
    "musicgen-medium": musicgen_medium,
    "smollm-135m": smollm_135m,
    "smollm-360m": smollm_360m,
    "minitron-4b": minitron_4b,
    "llama3.2-1b": llama3_2_1b,
    "rwkv6-1.6b": rwkv6_1_6b,
    "internvl2-1b": internvl2_1b,
}

ARCHS: Dict[str, Tuple[ModelConfig, ModelConfig]] = {
    name: (mod.FULL, mod.REDUCED) for name, mod in _MODULES.items()
}


def get_arch(name: str, reduced: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    full, red = ARCHS[name]
    return red if reduced else full


def all_cells():
    """Yield every (arch_name, cfg, shape_spec, runnable, skip_reason)."""
    for name, (full, _) in ARCHS.items():
        for shape in SHAPES.values():
            ok, reason = cell_applicable(full, shape)
            yield name, full, shape, ok, reason
