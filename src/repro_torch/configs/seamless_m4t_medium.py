"""seamless-m4t-medium [arXiv:2308.11596; hf] — enc-dec multimodal backbone.

12 encoder + 12 decoder layers, d_model 1024, 16 heads (MHA), d_ff 4096,
vocab 256206.  The audio frontend is a stub per the brief: ``input_specs``
supplies precomputed frame embeddings (B, S_enc, d_model).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=24,          # 12 enc + 12 dec
    enc_layers=12,
    dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256_206,
    head_dim=64,
    act="gelu",
    rope_theta=10_000.0,
    optimizer="adamw",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, enc_layers=2, dec_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256, head_dim=16, dtype="float32",
)
