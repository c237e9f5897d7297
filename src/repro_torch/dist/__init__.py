"""Cross-accelerator data movement of the port, as in ``repro.dist``.

Only the sharded hot-feature plane's peer-row exchange is ported
(``collectives``).  The reference's mesh and sharding context and its
hierarchical gradient mean (``hierarchical_psum_mean``, a mesh collective)
serve the LM stack and wait for it (ROADMAP, port queue: LM stack).
"""
from .collectives import exchange_peer_rows, peer_gather_rows, ring_order

__all__ = ["exchange_peer_rows", "peer_gather_rows", "ring_order"]
