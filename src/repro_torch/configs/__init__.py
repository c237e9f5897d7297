"""The LM architectures (port of ``repro/configs``: the ten config modules'
FULL and REDUCED numbers, the registry and the assigned input shapes) and
the paper's GNN configs."""
from .hyscale_gnn import PAPER_BATCH, PAPER_CONFIGS, PAPER_FANOUTS
from .registry import (ARCHS, SHAPES, ShapeSpec, all_cells, cell_applicable,
                       get_arch, input_specs)

__all__ = ["ARCHS", "get_arch", "PAPER_CONFIGS", "PAPER_BATCH",
           "PAPER_FANOUTS", "SHAPES", "ShapeSpec", "all_cells",
           "cell_applicable", "input_specs"]
