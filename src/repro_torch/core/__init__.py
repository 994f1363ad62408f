"""GenGNN core in PyTorch: graph representation, segment ops, the shared
layout plan, message passing and multi-graph packing."""
