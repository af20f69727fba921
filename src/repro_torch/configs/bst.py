"""bst — Behavior Sequence Transformer (Alibaba) [arXiv:1905.06874].
embed_dim=32 seq_len=20 1 block 8 heads mlp=1024-512-256.
A copy of the JAX package's ``configs/bst.py``."""
from repro_torch.models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    name="bst", arch="bst", embed_dim=32, seq_len=20,
    item_vocab=100_000_000, cat_vocab=100_000, n_dense=8,
    n_blocks=1, n_heads=8, mlp=(1024, 512, 256),
)

SMOKE = RecsysConfig(
    name="bst-smoke", arch="bst", embed_dim=16, seq_len=6,
    item_vocab=1000, cat_vocab=50, n_dense=8,
    n_blocks=1, n_heads=4, mlp=(32, 16),
)
