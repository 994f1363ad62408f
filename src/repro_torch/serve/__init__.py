"""Serving stack of the port: clock, executor, GNN engine facade, the
kernel-library cache (``aot.py``)."""
