"""minicpm-2b [arXiv:2404.06395; hf] — llama-like arch trained with the WSD
(warmup-stable-decay) schedule; the trainer's ``wsd`` schedule reproduces it."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,      # MHA (kv = heads)
    d_ff=5760,
    vocab=122_753,
    head_dim=64,
    act="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    optimizer="adamw",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=72, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, head_dim=18, dtype="float32",
)
