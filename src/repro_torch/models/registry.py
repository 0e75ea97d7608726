"""Architecture registry: resolve ``--arch <id>`` to the port's model functions
(port of ``repro.models.registry``): ``models/transformer.py`` for the
``dense`` and ``moe`` families, ``mamba.py`` for ``ssm``, ``rglru.py`` for
``hybrid`` and ``encdec.py`` for ``encdec``, whose ``forward`` takes a
``{"frames", "tokens"}`` batch.

``get_model(arch, device=...)`` returns a ``ModelAPI`` bound to one device
(``cuda`` unless the caller asks for the CPU, which runs the plain version of
the flash-attention kernel).  ``init(seed)`` draws the weights from a
``torch.Generator`` on that device, seeded with ``seed``.

``device="meta"`` is the abstract init of the dry run: ``init()`` builds the
parameters at full size on ``meta`` (allocating and drawing nothing), and
``init_cache``, ``forward``, ``loss`` and ``decode_step`` run on them for
their shapes.  ``input_specs``, ``cache_specs``, ``supported_cells`` and
``ALL_CELLS`` are the JAX registry's; the specs are ``meta`` tensors.
``params_tree``, ``state_tree`` and ``cache_tree`` name the port's trees by
the JAX package's leaf paths, in its flatten order, each layer group JAX
stacks as one leaf at the stacked shape (``launch/sharding.py`` reads them).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.core.solvers.registry import check_device
from repro_torch.interop import stacked_groups
from repro_torch.models import common as cm
from repro_torch.models import encdec, mamba, rglru, transformer
from repro_torch.models.config import SHAPES, ModelConfig
from repro_torch.train.tree import leaf_paths, leaves_with_paths, stacked_shape

META = torch.device("meta")

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
    dev = META if str(device) == "meta" else check_device(device)
    gen = ((lambda seed: cm.SHAPE_ONLY) if dev == META
           else (lambda seed: torch.Generator(dev).manual_seed(seed)))
    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=lambda seed=0: m.lm_init(gen(seed), cfg),
        loss=lambda p, batch, remat=True: m.lm_loss(p, batch, cfg, remat=remat),
        forward=lambda p, batch, last_only=False: m.lm_forward(p, batch, cfg,
                                                               last_only=last_only),
        init_cache=lambda batch, max_len: m.lm_init_cache(cfg, batch, max_len, dev),
        decode_step=lambda p, cache, tokens, pos: m.lm_decode_step(p, cache, tokens, pos, cfg),
    )


def _config(arch_id: str, smoke: bool, overrides: Optional[dict]) -> ModelConfig:
    cfg = smoke_config(arch_id) if smoke else get_config(arch_id)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(arch_id: str, shape_name: str, *, smoke: bool = False,
                overrides: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for the cell's step inputs (no allocation).

    train/prefill → {"tokens": (B, S)} (+ "frames" for enc-dec);
    decode        → {"pos": scalar, "tokens": (B, 1)} (the cache from
                    ``cache_specs``).
    Token ids are int32, as the loader feeds them; keys in JAX's flatten
    order (sorted)."""
    cfg = _config(arch_id, smoke, overrides)
    shape = SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            half = s // 2
            return {"frames": _meta((b, half, cfg.d_model), cfg.torch_dtype),
                    "tokens": _meta((b, half), i32)}
        return {"tokens": _meta((b, s), i32)}
    return {"pos": _meta((), i32), "tokens": _meta((b, 1), i32)}


def cache_len(cfg: ModelConfig, shape_name: str) -> tuple:
    """(batch, max_len) of a decode cell's cache (enc-dec: half the sequence)."""
    shape = SHAPES[shape_name]
    s = shape.seq_len // 2 if cfg.family == "encdec" else shape.seq_len
    return shape.global_batch, s


def cache_specs(arch_id: str, shape_name: str, *, smoke: bool = False,
                overrides: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The decode cell's cache on ``meta`` (no allocation), by JAX leaf path
    (``cache_tree``)."""
    api = get_model(arch_id, smoke=smoke, overrides=overrides, device="meta")
    return cache_tree(api.init_cache(*cache_len(api.cfg, shape_name)), api.cfg)


def supported_cells(arch_id: str):
    """The assigned shape list for this arch, with skip rationale applied."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if get_config(arch_id).is_subquadratic:
        cells.append("long_500k")
    return cells


ALL_CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


def stacked_names(cfg: ModelConfig) -> tuple:
    """The layer groups JAX stacks (``interop.stacked_groups``) that have layers."""
    return tuple(name for name, n in stacked_groups(cfg).items() if n)


def params_tree(params, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """{JAX path: leaf} of the port's parameters; a stacked group's leaf is a
    ``meta`` tensor of JAX's stacked shape."""
    stacked = stacked_names(cfg)
    out = {}
    for path, ts in leaf_paths(params, stacked):
        shape = stacked_shape(path, ts, stacked)
        out[path] = ts[0] if tuple(ts[0].shape) == shape else _meta(shape, ts[0].dtype)
    return out


def state_tree(state, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """{JAX path: leaf} of a ``train.TrainState``, as JAX's ``TrainState``
    flattens: ``step``, ``params/…``, then ``opt_state/…`` (adamw's
    ``count``, ``m/…``, ``v/…``; adafactor's ``count``, ``stats/…/vc``,
    ``…/vr`` or ``…/v``), each statistic in the parameters' order."""
    params = params_tree(state.params, cfg)
    out = {"step": state.step, **{f"params/{p}": t for p, t in params.items()}}
    opt = state.opt_state
    for key in sorted(opt):
        if key == "count":
            out["opt_state/count"] = opt["count"]
        elif key == "stats":
            for p in params:
                for stat in sorted(opt["stats"][p]):
                    out[f"opt_state/stats/{p}/{stat}"] = opt["stats"][p][stat]
        else:
            out.update({f"opt_state/{key}/{p}": opt[key][p] for p in params})
    return out


def cache_tree(cache, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """{JAX path: leaf} of the port's decode cache, in JAX's layout:
    mamba's ``main`` group is JAX's top level; rglru's stacked ``rec`` and
    ``attn`` groups are JAX's list of layers (``"{i}/h"``, ``"{i}/k"``, …, in
    the layer pattern's order); enc-dec's ``self``/``cross`` groups are
    JAX's ``self_k``, ``cross_v``, …, and ``cross/len`` (the port keeps one
    length a layer and row) is JAX's ``cross_len``."""
    if cfg.family == "ssm":
        return dict(leaves_with_paths(cache["main"]))
    if cfg.family == "hybrid":
        out = {}
        for i, kind in enumerate(cfg.pattern()):
            group = cache["rec" if kind == "r" else "attn"]
            for name in sorted(group):
                out[f"{i}/{name}"] = _meta(tuple(group[name].shape[1:]), group[name].dtype)
        return out
    if cfg.family == "encdec":
        flat = {f"{g}_{n}": t for g in ("self", "cross") for n, t in cache[g].items()}
        return {k: flat[k] for k in sorted(flat)}
    return dict(leaves_with_paths(cache))
