"""``python -m repro_torch.analysis`` entry point."""
import sys

from .engine import main

sys.exit(main())
