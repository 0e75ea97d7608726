"""Prepared device-resident dataset: padded layouts + cached solver setup
(port of ``repro.core.solvers.prepared``).

``PreparedDataset`` is what the registry's padded coercion returns for a
``repro_torch.data.store.DatasetStore``: the ``(PaddedCSR, PaddedCSC)`` pair
on one device plus a memo of the config-independent Frank-Wolfe setup state
``(v̄₀, q̄₀, α₀)`` per loss — the setup ``Xᵀq`` sweep that ``torch_sparse``
would otherwise re-run on every solve.

Exactness contract: on a cache miss the setup is computed by the *same*
``torch_sparse.fw_setup`` the un-prepared path calls (on the card, the
``ell_rmatvec`` kernel), then persisted through the ``saver`` hook, under a
file of the device it was computed on.  A hit therefore replays identical
bits, which is why ``solve(store)`` takes exactly the same iterates as
``solve(X, y)`` on the same device (``tests/test_torch_store.py``).

The cached setup is keyed to the labels it was computed against: calling
``setup_for`` with other labels bypasses the cache and computes fresh
(never poisoning the persisted state).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sparse.formats import PaddedCSC, PaddedCSR

SetupState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # (v̄₀, q̄₀, α₀)
SetupLoader = Callable[[str, torch.device], Optional[SetupState]]
SetupSaver = Callable[[str, torch.device, SetupState], None]
# (backend, loss, platform) -> persisted autotune.TuningRecord or None
TuningLoader = Callable[[str, str, str], Optional[object]]


@dataclasses.dataclass
class PreparedDataset:
    """Padded pair on one device + per-loss setup cache, bound to one label
    vector."""

    pcsr: PaddedCSR
    pcsc: PaddedCSC
    y: np.ndarray                         # labels the setup cache is bound to
    loader: Optional[SetupLoader] = None  # disk-cache read hook (store)
    saver: Optional[SetupSaver] = None    # disk-cache write hook (store)
    tuning_loader: Optional[TuningLoader] = None
    _setup: Dict[str, SetupState] = dataclasses.field(default_factory=dict)
    # (backend, loss, platform) -> TuningRecord | None (None memoizes a miss)
    _tuning: Dict[Tuple[str, str, str], Optional[object]] = dataclasses.field(
        default_factory=dict)
    _tuned_csc: Dict[int, object] = dataclasses.field(default_factory=dict)

    @property
    def shape(self):
        return self.pcsr.shape

    @property
    def device(self) -> torch.device:
        return self.pcsr.device

    @property
    def pair(self) -> Tuple[PaddedCSR, PaddedCSC]:
        return self.pcsr, self.pcsc

    def _bound_labels(self, y) -> bool:
        # the setup sees float32 labels, so equality in float32 decides
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        y = y.astype(np.float32)
        return y.shape == self.y.shape and bool(np.array_equal(y, self.y.astype(np.float32)))

    def setup_for(self, y, loss: str) -> SetupState:
        """(v̄₀, q̄₀, α₀) for this dataset — cached, disk-backed, exact."""
        from repro_torch.core.solvers.torch_sparse import fw_setup
        if not self._bound_labels(y):
            # foreign labels: correct answer, but never cached
            y_dev = torch.as_tensor(y, dtype=torch.float32).to(self.device)
            return fw_setup(self.pcsr, y_dev, loss=loss, pcsc=self.pcsc)
        if loss not in self._setup:
            state = self.loader(loss, self.device) if self.loader else None
            if state is None:
                y_dev = torch.from_numpy(self.y.astype(np.float32)).to(self.device)
                state = fw_setup(self.pcsr, y_dev, loss=loss, pcsc=self.pcsc)
                if self.saver is not None:
                    self.saver(loss, self.device, state)
            self._setup[loss] = tuple(state)
        return self._setup[loss]

    # ----------------------------------------------------- tuned layout
    def tuning_for(self, backend: str, loss: str, platform: Optional[str] = None):
        """The dataset's persisted tuning winner for (backend, loss) on this
        device's platform (``torch-cuda``/``torch-cpu``), or None.  Misses are
        memoized too."""
        if platform is None:
            from repro_torch.core.solvers.autotune import platform_of
            platform = platform_of(self.device)
        key = (backend, loss, platform)
        if key not in self._tuning:
            self._tuning[key] = (self.tuning_loader(backend, loss, platform)
                                 if self.tuning_loader else None)
        return self._tuning[key]

    def set_tuning(self, record) -> None:
        """Install a freshly searched record in memory (the tuner's hook, so
        the session that ran the search also uses it)."""
        self._tuning[(record.backend, record.loss, record.platform)] = record

    def tuned_pcsc(self, record):
        """The CSC layout ``record`` names: the tiered split at its
        ``ell_width``, memoized per width; the flat layout when untuned."""
        if record is None or record.ell_width is None:
            return self.pcsc
        width = int(record.ell_width)
        if width not in self._tuned_csc:
            from repro_torch.core.sparse.formats import tiered_from_padded
            self._tuned_csc[width] = tiered_from_padded(self.pcsc, width)
        return self._tuned_csc[width]
