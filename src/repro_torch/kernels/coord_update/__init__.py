from repro_torch.kernels.coord_update.ops import coord_update  # noqa: F401
