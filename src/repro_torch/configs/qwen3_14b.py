"""qwen3-14b — dense GQA with qk-norm [hf:Qwen/Qwen3-14B].
40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
A copy of the JAX package's ``configs/qwen3_14b.py``."""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40,
    n_kv_heads=8, head_dim=128, d_ff=17408, vocab=151936,
    attn_type="gqa", ffn_type="swiglu", qk_norm=True,
    rope_base=1000000.0, q_chunk=512,
)

SMOKE = LMConfig(
    name="qwen3-14b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=160, vocab=512,
    attn_type="gqa", ffn_type="swiglu", qk_norm=True, q_chunk=16,
    remat=False,
)
