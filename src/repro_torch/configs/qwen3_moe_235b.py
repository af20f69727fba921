"""qwen3-moe-235b-a22b — GQA(kv=4) + 128-expert top-8 MoE
[hf:Qwen/Qwen3-235B-A22B]. 94L d_model=4096 64H d_ff(expert)=1536
vocab=151936.
A copy of the JAX package's ``configs/qwen3_moe_235b.py``."""
from repro_torch.models.lm import LMConfig
from repro_torch.models.moe import MoEConfig

CONFIG = LMConfig(
    name="qwen3-moe-235b-a22b", n_layers=94, d_model=4096, n_heads=64,
    n_kv_heads=4, head_dim=128, d_ff=1536, vocab=151936,
    attn_type="gqa", ffn_type="swiglu", qk_norm=True,
    rope_base=1000000.0, q_chunk=512, n_dense_layers=0,
    moe=MoEConfig(d_model=4096, d_ff=1536, n_experts=128, top_k=8,
                  n_shared=0, capacity_factor=1.25, aux_weight=0.001),
)

SMOKE = LMConfig(
    name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=96, vocab=512,
    attn_type="gqa", ffn_type="swiglu", qk_norm=True, q_chunk=16,
    remat=False, n_dense_layers=0,
    moe=MoEConfig(d_model=64, d_ff=32, n_experts=8, top_k=2, n_shared=0),
)
