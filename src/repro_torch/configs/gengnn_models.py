"""The paper's six GNN models (Table 2 / §5.1 hyperparameters) as
selectable configs; ``gin_vn`` is GIN with the virtual node."""
from repro_torch.gnn.models import GNNConfig, paper_config

GNN_MODELS = ("gcn", "gin", "gin_vn", "gat", "pna", "dgn")


def get_gnn_config(name: str, **kw) -> GNNConfig:
    if name == "gin_vn":
        return paper_config("gin", virtual_node=True, **kw)
    return paper_config(name, **kw)
