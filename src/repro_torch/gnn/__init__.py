"""Model-specific component library (paper §4): the six models in fp32."""
from repro_torch.gnn.models import GNNConfig, apply, init, paper_config

__all__ = ["GNNConfig", "paper_config", "init", "apply"]
