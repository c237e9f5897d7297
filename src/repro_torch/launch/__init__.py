"""Launchers of the port (``repro/launch`` and ``examples/``): the serving
CLI and the GNN training CLI."""
