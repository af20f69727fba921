"""deepseek-7b — dense llama-arch decoder [arXiv:2401.02954; hf].
30L d_model=4096 32H (GQA kv=32 => MHA) d_ff=11008 vocab=102400.
A copy of the JAX package's ``configs/deepseek_7b.py``."""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="deepseek-7b", n_layers=30, d_model=4096, n_heads=32,
    n_kv_heads=32, head_dim=128, d_ff=11008, vocab=102400,
    attn_type="gqa", ffn_type="swiglu", rope_base=10000.0, q_chunk=512,
)

SMOKE = LMConfig(
    name="deepseek-7b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=160, vocab=512,
    attn_type="gqa", ffn_type="swiglu", q_chunk=16, remat=False,
)
