"""recurrentgemma-2b [arXiv:2402.19427; hf] — Griffin: RG-LRU + local attention.

Pattern (recurrent, recurrent, local-attn) tiled over 26 layers; MQA (kv=1),
head_dim 256, window 2048, GeGLU d_ff 7680, lru width = d_model.
Sub-quadratic (window-bounded attention) → runs the long_500k cell.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256_000,
    head_dim=256,
    act="geglu",
    window=2048,
    layer_pattern="rra",
    d_rnn=2560,
    conv_kernel=4,
    emb_scale=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    optimizer="adamw",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
    vocab=256, head_dim=32, d_rnn=64, window=32, dtype="float32",
)
