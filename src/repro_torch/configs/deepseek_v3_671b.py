"""deepseek-v3-671b — MLA + shared/routed MoE + MTP [arXiv:2412.19437].
61L d_model=7168 128H d_ff(expert)=2048 vocab=129280, 1 shared + 256 routed
top-8, first 3 layers dense (d_ff=18432), MTP depth 1.
A copy of the JAX package's ``configs/deepseek_v3_671b.py``."""
from repro_torch.models.lm import LMConfig
from repro_torch.models.moe import MoEConfig

CONFIG = LMConfig(
    name="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128,
    n_kv_heads=128, head_dim=128, d_ff=18432, vocab=129280,
    attn_type="mla", ffn_type="swiglu", rope_base=10000.0, q_chunk=512,
    n_dense_layers=3, mtp_depth=1,
    moe=MoEConfig(d_model=7168, d_ff=2048, n_experts=256, top_k=8,
                  n_shared=1, shared_d_ff=2048, capacity_factor=1.25,
                  aux_weight=0.0001),
)

SMOKE = LMConfig(
    name="deepseek-v3-671b-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=160, vocab=512,
    attn_type="mla", ffn_type="swiglu", q_chunk=16, remat=False,
    n_dense_layers=1, mtp_depth=1,
    moe=MoEConfig(d_model=64, d_ff=32, n_experts=8, top_k=2, n_shared=1,
                  shared_d_ff=32),
)
