"""The paper's own workloads — DP LASSO logistic regression datasets (Table 2)
and hyperparameters (§4: T=4000, λ=50 speed runs; T=400000, λ=5000 accuracy
runs; ε ∈ {1, 0.1}, δ = 1/N²).

Real files are not available offline; ``repro_torch.data.synthetic`` generates
sparse design matrices matched to each dataset's (N, D, nnz/row) so the
benchmark harness reproduces the paper's tables at selectable scale.
"""
import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class LassoDataset:
    name: str
    n: int
    d: int
    nnz_per_row: float     # average S_c (public dataset statistics)
    informative: int       # features carrying signal in the synthetic twin
    dense_features: int = 0  # URL-style dense informative block


DATASETS: Dict[str, LassoDataset] = {
    "rcv1": LassoDataset("rcv1", 20_242, 47_236, 73.2, 512),
    "news20": LassoDataset("news20", 19_996, 1_355_191, 454.9, 1024),
    "url": LassoDataset("url", 2_396_130, 3_231_961, 115.6, 512, dense_features=200),
    "web": LassoDataset("web", 350_000, 16_609_143, 3727.7, 1024),
    "kdda": LassoDataset("kdda", 8_407_752, 20_216_830, 36.3, 512),
}


@dataclasses.dataclass(frozen=True)
class PaperRun:
    lam: float
    steps: int
    epsilon: float
    delta_rule: str = "1/n^2"


SPEED_RUN = PaperRun(lam=50.0, steps=4000, epsilon=1.0)
SPEED_RUN_HIGH_PRIVACY = PaperRun(lam=50.0, steps=4000, epsilon=0.1)
ACCURACY_RUN = PaperRun(lam=5000.0, steps=400_000, epsilon=0.1)

CONFIG = {
    "datasets": DATASETS,
    "speed": SPEED_RUN,
    "speed_high_privacy": SPEED_RUN_HIGH_PRIVACY,
    "accuracy": ACCURACY_RUN,
}

# CPU-runnable reduced twin (same generator, smaller N/D) for tests/benches.
SMOKE = {
    "rcv1": LassoDataset("rcv1-smoke", 2000, 4000, 40.0, 64),
    "news20": LassoDataset("news20-smoke", 1000, 20_000, 100.0, 128),
    "url": LassoDataset("url-smoke", 4000, 8000, 30.0, 64, dense_features=20),
}
