"""chameleon-34b [arXiv:2405.09818; unverified] — early-fusion VLM backbone.

Images enter as discrete VQ tokens inside the 65536-entry vocabulary, so the
backbone is a dense llama-style LM with qk-norm (Chameleon's stability fix);
the VQ tokenizer frontend is a stub per the assignment brief.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="dense",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_016,
    vocab=65_536,
    head_dim=128,
    qk_norm=True,
    act="swiglu",
    rope_theta=10_000.0,
    optimizer="adafactor",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, head_dim=16, dtype="float32",
)
