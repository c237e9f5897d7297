"""Launchers of the port (``repro/launch`` and ``examples/``): the serving
CLI, the LM training CLI and the GNN training CLI."""
