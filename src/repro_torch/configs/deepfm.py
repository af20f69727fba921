"""deepfm [arXiv:1703.04247]. 39 sparse fields, embed_dim=10,
mlp=400-400-400, FM interaction (the fused_fm CUDA kernel on the card).
A copy of the JAX package's ``configs/deepfm.py``."""
from repro_torch.models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    name="deepfm", arch="deepfm", embed_dim=10, n_sparse_fields=39,
    field_vocab=1_000_000, n_dense=13, mlp=(400, 400, 400),
)

SMOKE = RecsysConfig(
    name="deepfm-smoke", arch="deepfm", embed_dim=10, n_sparse_fields=7,
    field_vocab=100, n_dense=13, mlp=(32, 32),
)
