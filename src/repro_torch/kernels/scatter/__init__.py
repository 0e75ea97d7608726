from repro_torch.kernels.scatter.ops import scatter_add_ordered  # noqa: F401
