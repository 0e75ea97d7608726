from repro_torch.kernels.flash_attention.ops import (flash_attention,  # noqa: F401
                                                     flash_attention_bwd,
                                                     flash_attention_with_lse)
