"""Architecture registry: resolve ``--arch <id>`` to the port's model functions
(port of ``repro.models.registry``): ``models/transformer.py`` for the
``dense`` and ``moe`` families, ``mamba.py`` for ``ssm``, ``rglru.py`` for
``hybrid`` and ``encdec.py`` for ``encdec``, whose ``forward`` takes a
``{"frames", "tokens"}`` batch.

``get_model(arch, device=...)`` returns a ``ModelAPI`` bound to one device
(``cuda`` unless the caller asks for the CPU, which runs the plain version of
the flash-attention kernel).  ``init(seed)`` draws the weights from a
``torch.Generator`` on that device, seeded with ``seed``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.solvers.registry import check_device
from repro_torch.models import encdec, mamba, rglru, transformer
from repro_torch.models.config import ModelConfig

FAMILY_MODULES = {"ssm": mamba, "hybrid": rglru, "encdec": encdec}


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    """Uniform surface over the model families."""

    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Any]
    loss: Callable[..., Any]
    forward: Callable[..., Any]
    init_cache: Callable[..., Any]
    decode_step: Callable[..., Any]


def get_model(arch_id: str, *, smoke: bool = False, overrides: Optional[dict] = None,
              device: str = "cuda") -> ModelAPI:
    """``overrides``: ``dataclasses.replace`` fields applied to the config."""
    cfg = smoke_config(arch_id) if smoke else get_config(arch_id)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    m = FAMILY_MODULES.get(cfg.family, transformer)       # else dense / moe
    dev = check_device(device)
    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=lambda seed=0: m.lm_init(torch.Generator(dev).manual_seed(seed), cfg),
        loss=lambda p, batch, remat=True: m.lm_loss(p, batch, cfg, remat=remat),
        forward=lambda p, batch, last_only=False: m.lm_forward(p, batch, cfg,
                                                               last_only=last_only),
        init_cache=lambda batch, max_len: m.lm_init_cache(cfg, batch, max_len, dev),
        decode_step=lambda p, cache, tokens, pos: m.lm_decode_step(p, cache, tokens, pos, cfg),
    )
