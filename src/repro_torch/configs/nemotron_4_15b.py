"""nemotron-4-15b [arXiv:2402.16819; unverified] — GQA kv=8, squared-ReLU MLP."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24_576,
    vocab=256_000,
    head_dim=128,
    act="relu2",
    rope_theta=10_000.0,
    optimizer="adamw",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=96, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab=256, head_dim=24, dtype="float32",
)
