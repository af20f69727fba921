"""din — Deep Interest Network [arXiv:1706.06978].
embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80 target-attention.
A copy of the JAX package's ``configs/din.py``."""
from repro_torch.models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    name="din", arch="din", embed_dim=18, seq_len=100,
    item_vocab=100_000_000, cat_vocab=100_000, n_dense=8,
    attn_mlp=(80, 40), mlp=(200, 80),
)

SMOKE = RecsysConfig(
    name="din-smoke", arch="din", embed_dim=18, seq_len=10,
    item_vocab=1000, cat_vocab=50, n_dense=8,
    attn_mlp=(16, 8), mlp=(32, 16),
)
