"""nemotron-4-340b — dense GQA with squared-ReLU FFN [arXiv:2402.16819].
96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
A copy of the JAX package's ``configs/nemotron_4_340b.py``."""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="nemotron-4-340b", n_layers=96, d_model=18432, n_heads=96,
    n_kv_heads=8, head_dim=192, d_ff=73728, vocab=256000,
    attn_type="gqa", ffn_type="squared_relu", rope_base=10000.0,
    q_chunk=512,
)

SMOKE = LMConfig(
    name="nemotron-4-340b-smoke", n_layers=2, d_model=96, n_heads=4,
    n_kv_heads=2, head_dim=24, d_ff=384, vocab=512,
    attn_type="gqa", ffn_type="squared_relu", q_chunk=16, remat=False,
)
