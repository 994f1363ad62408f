"""Model-specific component library (paper §4): GCN and GIN in this slice."""
from repro_torch.gnn.models import GNNConfig, apply, init, paper_config

__all__ = ["GNNConfig", "paper_config", "init", "apply"]
