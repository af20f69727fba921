"""two-tower-retrieval — sampled-softmax retrieval [Yi et al., RecSys'19].
embed_dim=256 tower_mlp=1024-512-256 dot interaction; the user tower's
history bag runs on the embedding_bag CUDA kernel on the card.
A copy of the JAX package's ``configs/two_tower_retrieval.py``."""
from repro_torch.models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    name="two-tower-retrieval", arch="two_tower", embed_dim=256,
    seq_len=50, item_vocab=10_000_000, cat_vocab=100_000,
    user_vocab=20_000_000, n_dense=8, tower_mlp=(1024, 512, 256),
)

SMOKE = RecsysConfig(
    name="two-tower-smoke", arch="two_tower", embed_dim=32,
    seq_len=8, item_vocab=1000, cat_vocab=50, user_vocab=2000,
    n_dense=8, tower_mlp=(64, 32),
)
