"""graphsage-reddit [arXiv:1706.02216]. 2 layers, d_hidden=128, mean
aggregator, sample sizes 25-10.  d_feat/n_classes come from each cell
(cora / reddit / ogbn-products / molecule).  A copy of the JAX package's
``configs/graphsage_reddit.py``; the neighbour mean runs on the
``csr_sum`` CUDA kernel on the card."""
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    name="graphsage-reddit", n_layers=2, d_hidden=128, d_feat=602,
    n_classes=41, aggregator="mean", fanouts=(25, 10),
)

SMOKE = GNNConfig(
    name="graphsage-smoke", n_layers=2, d_hidden=16, d_feat=24,
    n_classes=5, aggregator="mean", fanouts=(4, 3),
)
