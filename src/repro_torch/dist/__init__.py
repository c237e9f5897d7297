"""Cross-accelerator data movement of the port, as in ``repro.dist``.

Only the sharded hot-feature plane's peer-row exchange is ported
(``collectives``).  The LM stack trains and serves on one card without a
mesh; the reference's mesh and sharding context and its hierarchical
gradient mean (``hierarchical_psum_mean``, a mesh collective) wait for the
mesh route (ROADMAP: LM stack, the mesh route).
"""
from .collectives import exchange_peer_rows, peer_gather_rows, ring_order

__all__ = ["exchange_peer_rows", "peer_gather_rows", "ring_order"]
