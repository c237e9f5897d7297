"""The check that the run loaded no JAX: top-level module names compared
whole (``repro_torch`` is the port, ``repro`` the JAX package)."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden(names: Iterable[str] = None) -> List[str]:
    """Sorted forbidden top-level names among ``names`` (default: the
    modules this process has loaded)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)
