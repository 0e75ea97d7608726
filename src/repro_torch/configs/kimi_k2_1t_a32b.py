"""kimi-k2-1t-a32b [arXiv:2501.kimi2; unverified] — trillion-param MoE.

Per the assignment's paper-table spec: 61L, d_model 7168, 64 heads with GQA
kv=8, 384 routed experts top-8 with expert d_ff 2048 (+1 shared expert and a
dense first layer with d_ff 18432, following the K2 lineage).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=18_432,          # leading dense layer
    vocab=163_840,
    head_dim=112,         # d_model / n_heads
    n_experts=384,
    n_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    first_dense_layers=1,
    act="swiglu",
    rope_theta=50_000.0,
    optimizer="adafactor",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16, n_experts=4, n_shared_experts=1, top_k=2,
    moe_d_ff=32, first_dense_layers=1, dtype="float32",
)
