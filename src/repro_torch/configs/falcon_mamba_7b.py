"""falcon-mamba-7b [arXiv:2410.05355; unverified] — attention-free Mamba-1.

d_inner = 2·d_model, ssm_state = 16, dt_rank = d_model/16 = 256, conv 4.
Sub-quadratic → runs the long_500k cell.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=65_024,
    ssm_state=16,
    d_inner=8192,
    conv_kernel=4,
    dt_rank=256,
    optimizer="adamw",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, d_inner=128, dt_rank=8, vocab=256,
    dtype="float32",
)
