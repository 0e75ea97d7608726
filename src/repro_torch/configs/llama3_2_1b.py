"""llama3.2-1b [hf:meta-llama/Llama-3.2-1B; unverified] — small llama3."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128_256,
    head_dim=64,
    act="swiglu",
    rope_theta=500_000.0,
    tie_embeddings=True,
    optimizer="adamw",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16, dtype="float32",
)
