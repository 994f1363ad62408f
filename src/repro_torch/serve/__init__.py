"""Serving stack of the port: clock, executor, GNN engine facade."""
