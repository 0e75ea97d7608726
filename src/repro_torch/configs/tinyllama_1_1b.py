"""tinyllama-1.1b [arXiv:2401.02385; hf] — llama2-arch small, GQA kv=4."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32_000,
    head_dim=64,
    act="swiglu",
    rope_theta=10_000.0,
    optimizer="adamw",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab=256, head_dim=16, dtype="float32",
)
