from repro_torch.kernels.spmv.ops import ell_matvec, ell_rmatvec  # noqa: F401
