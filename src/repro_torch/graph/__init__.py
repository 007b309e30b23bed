"""Streaming-graph substrate of the port: static CSR snapshots, synthetic
generators and update-stream workloads (numpy copies of ``repro.graph``)."""

from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.generators import (
    barabasi_albert,
    erdos_renyi,
    make_graph,
    random_features,
)
from repro_torch.graph.streaming import (
    ADVERSARIAL_REGIMES,
    StreamWorkload,
    UpdateBatch,
    make_adversarial_stream,
    make_stream,
)

__all__ = [
    "CSRGraph",
    "UpdateBatch",
    "StreamWorkload",
    "make_stream",
    "make_adversarial_stream",
    "ADVERSARIAL_REGIMES",
    "barabasi_albert",
    "erdos_renyi",
    "make_graph",
    "random_features",
]
