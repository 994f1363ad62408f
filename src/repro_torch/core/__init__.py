"""GenGNN core in PyTorch: graph representation, segment ops, the shared
layout plan, message passing and multi-graph packing (the exports of
``repro.core``)."""
from repro_torch.core.graph import (
    Graph,
    CSRGraph,
    coo_to_compressed,
    from_numpy,
    batch_graphs,
    in_degree,
    out_degree,
)
from repro_torch.core.message_passing import (
    mp_layer,
    gather_scatter,
    global_pool,
    pna_aggregate,
    pna_scalers,
    AGGREGATORS,
)
from repro_torch.core.batching import (
    BucketBudget,
    PackMeta,
    pack_graphs,
    pack_layout,
    pack_eigvecs,
    unpack_outputs,
)
from repro_torch.core.layout import (
    GraphLayout,
    build_layout,
    host_layout,
    ensure_layout,
)
from repro_torch.core.scatter_gather import (
    segment_reduce,
    sorted_segment_reduce,
    sort_by_segment,
    rank_within_segment,
    dispatch_to_slots,
    combine_from_slots,
)

__all__ = [
    "Graph",
    "CSRGraph",
    "coo_to_compressed",
    "from_numpy",
    "batch_graphs",
    "in_degree",
    "out_degree",
    "BucketBudget",
    "PackMeta",
    "pack_graphs",
    "pack_layout",
    "pack_eigvecs",
    "unpack_outputs",
    "GraphLayout",
    "build_layout",
    "host_layout",
    "ensure_layout",
    "mp_layer",
    "gather_scatter",
    "global_pool",
    "pna_aggregate",
    "pna_scalers",
    "AGGREGATORS",
    "segment_reduce",
    "sorted_segment_reduce",
    "sort_by_segment",
    "rank_within_segment",
    "dispatch_to_slots",
    "combine_from_slots",
]
