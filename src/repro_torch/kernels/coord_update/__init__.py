from repro_torch.kernels.coord_update.ops import coord_update, coord_update_lanes  # noqa: F401
