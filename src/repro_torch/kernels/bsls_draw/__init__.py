from repro_torch.kernels.bsls_draw.ops import two_level_draw, two_level_draw_lanes  # noqa: F401
