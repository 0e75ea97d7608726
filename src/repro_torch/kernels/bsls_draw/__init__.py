from repro_torch.kernels.bsls_draw.ops import two_level_draw  # noqa: F401
