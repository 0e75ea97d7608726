"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches must
see the real single CPU device (the dry-run sets its own flag in-process).
Multi-device tests spawn subprocesses (see test_distributed_fw.py)."""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one (run on the card with "
        "`PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py`)")


@pytest.fixture(scope="session")
def tiny_problem():
    """Small sparse classification problem shared across FW tests."""
    from repro.data.synthetic import make_sparse_classification
    X, y, w_true = make_sparse_classification(
        n=300, d=1200, nnz_per_row=15, informative=25, seed=7)
    return X, y, w_true


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
