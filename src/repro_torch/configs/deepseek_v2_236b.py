"""deepseek-v2-236b [arXiv:2405.04434; hf] — MLA (kv_lora=512, q_lora=1536)
+ MoE: 160 routed experts top-6 with 2 shared experts, expert d_ff=1536.
First layer uses a dense FFN (d_ff=12288), per the HF config.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,       # MLA: per-head k/v up-projected from the latent
    d_ff=12_288,          # the single leading dense layer
    vocab=102_400,
    head_dim=128,         # qk nope dims
    use_mla=True,
    kv_lora=512,
    q_lora=1536,
    rope_head_dim=64,
    v_head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    first_dense_layers=1,
    act="swiglu",
    rope_theta=10_000.0,
    optimizer="adafactor",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, head_dim=16, kv_lora=32, q_lora=48, rope_head_dim=8,
    v_head_dim=16, n_experts=4, n_shared_experts=1, top_k=2, moe_d_ff=32,
    first_dense_layers=1, dtype="float32",
)
