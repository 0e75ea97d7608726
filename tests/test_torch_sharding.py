"""The port's sharding rules and abstract init against the JAX package's, on the CPU.

For every arch at full size and on three meshes (16×16, 2×16×16, and a 4×12
mesh whose sizes do not divide the widths, so dims fall back), the port's
spec per JAX leaf and its fallback log (an ordered list) equal
``repro.launch.sharding``'s for: the parameters under each ``fsdp`` grade;
the train state (parameters and the arch's optimizer state); the decode
caches of the supported cells; the batch of every supported cell, with the
default axes and with ``dp="full"``'s.

The JAX side needs no devices: ``_sanitize`` reads only the mesh's
``axis_names`` and ``devices.shape``, so the mesh is a stub, and
``NamedSharding`` is replaced by a box holding the spec.  One leaf differs
by design: the port's enc-dec cache keeps a length a layer and row
(``cross_len`` is (L, B) int64, JAX's a scalar); both replicate it.

The abstract init (``get_model(..., device="meta")``) gives a real CPU
init's shapes and dtypes, for the parameters, the optimizer state and the
cache, at smoke size.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import sharding as jshd
from repro.models import registry as jreg
from repro.train.optimizer import get_optimizer as j_get_optimizer
from repro.train.trainer import TrainState as JTrainState
from repro_torch.configs import ARCH_IDS
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import Mesh, make_production_mesh, shard_grid
from repro_torch.models import registry as reg
from repro_torch.models.config import SHAPES
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.trainer import make_train_state
from repro_torch.train.tree import leaves_with_paths

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "4x12": (("data", "model"), (4, 12))}
FSDP = (False, "zero2", "zero3_moe", True)
FULL_DP = ("pod", "data", "model")


class _Box:
    """Stands in for a ``NamedSharding``: the spec, and a pytree leaf."""

    def __init__(self, spec):
        self.spec = tuple(spec)


@pytest.fixture(autouse=True)
def _boxed(monkeypatch):
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: _Box(spec))


def _jax_specs(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, _Box))
    return {jshd._path_str(path): box.spec for path, box in leaves}


def _meshes(name):
    axes, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape)), Mesh(axes, shape)


@functools.lru_cache(maxsize=None)
def _jax_abstract(arch):
    api = jreg.get_model(arch)
    opt = j_get_optimizer(api.cfg.optimizer)

    def state(key):
        params = api.init(key)
        return JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=opt.init(params))

    key = jax.random.PRNGKey(0)
    return jax.eval_shape(api.init, key), jax.eval_shape(state, key)


@functools.lru_cache(maxsize=None)
def _port_abstract(arch):
    api = reg.get_model(arch, device="meta")
    params = api.init()
    state = make_train_state(params, get_optimizer(api.cfg.optimizer), reg.stacked_names(api.cfg))
    return reg.params_tree(params, api.cfg), reg.state_tree(state, api.cfg)


def _same(jax_specs, jax_log, port_specs, port_log, port_tree=None, jax_tree=None):
    assert list(port_specs) == list(jax_specs)
    for path, spec in jax_specs.items():
        if port_tree is not None and tuple(port_tree[path].shape) != tuple(jax_tree[path]):
            # a leaf the port lays out otherwise: both replicate it
            assert all(s is None for s in spec) and all(s is None for s in port_specs[path])
            continue
        assert port_specs[path] == spec, path
    assert port_log == jax_log


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_and_train_state_specs_match_jax(arch, mesh_name):
    jmesh, pmesh = _meshes(mesh_name)
    j_params, j_state = _jax_abstract(arch)
    p_params, p_state = _port_abstract(arch)
    for fsdp in FSDP:
        for jt, pt in ((j_params, p_params), (j_state, p_state)):
            jlog, plog = [], []
            _same(_jax_specs(jshd.params_shardings(jt, jmesh, jlog, fsdp=fsdp)), jlog,
                  shd.params_shardings(pt, pmesh, plog, fsdp=fsdp), plog)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_match_jax(arch, mesh_name):
    jmesh, pmesh = _meshes(mesh_name)
    for cell in jreg.supported_cells(arch):
        if SHAPES[cell].kind == "decode":
            j_cache = jreg.cache_specs(arch, cell)
            p_cache = reg.cache_specs(arch, cell)
            j_shapes = {jshd._path_str(p): leaf.shape for p, leaf in
                        jax.tree_util.tree_flatten_with_path(j_cache)[0]}
            jlog, plog = [], []
            _same(_jax_specs(jshd.cache_shardings(j_cache, jmesh, jlog)), jlog,
                  shd.cache_shardings(p_cache, pmesh, plog), plog, p_cache, j_shapes)
        for axes in (None, FULL_DP):
            jlog, plog = [], []
            _same(_jax_specs(jshd.batch_shardings(jreg.input_specs(arch, cell), jmesh, jlog,
                                                  axes=axes)), jlog,
                  shd.batch_shardings(reg.input_specs(arch, cell), pmesh, plog, axes=axes),
                  plog)


def test_production_meshes_and_registry_lists():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (single.axis_names, single.shape, single.name) == (("data", "model"), (16, 16),
                                                              "16x16")
    assert (multi.axis_names, multi.shape, multi.name) == (("pod", "data", "model"),
                                                           (2, 16, 16), "2x16x16")
    assert shard_grid(single) == (16, 16) and shard_grid(multi) == (32, 16)
    assert reg.ALL_CELLS == jreg.ALL_CELLS
    for arch in ARCH_IDS:
        assert reg.supported_cells(arch) == jreg.supported_cells(arch)
        for cell in SHAPES:
            j_in, p_in = jreg.input_specs(arch, cell), reg.input_specs(arch, cell)
            assert list(p_in) == sorted(j_in)
            for k, leaf in j_in.items():
                assert tuple(p_in[k].shape) == tuple(leaf.shape)
                assert p_in[k].dtype.itemsize == np.dtype(leaf.dtype).itemsize
                assert p_in[k].device.type == "meta"


def test_shard_shape_and_device_bytes():
    mesh = Mesh(("pod", "data", "model"), (2, 4, 8))
    assert shd.shard_shape((64, 48, 10), (("pod", "data"), "model", None), mesh) == (8, 6, 10)
    assert shd.shard_shape((64, 48), ("model",), mesh) == (64, 6)       # right-aligned
    tree = {"a": torch.empty((64, 48), dtype=torch.bfloat16, device="meta"),
            "b": torch.empty((), dtype=torch.int32, device="meta")}
    specs = {"a": ("data", "model"), "b": ()}
    assert shd.device_bytes(tree, specs, mesh) == 16 * 6 * 2 + 4


def _shapes(tree):
    return [(p, tuple(t.shape), t.dtype) for p, t in leaves_with_paths(tree)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_init_matches_a_real_init(arch):
    meta = reg.get_model(arch, smoke=True, device="meta")
    real = reg.get_model(arch, smoke=True, device="cpu")
    mp, rp = meta.init(), real.init(0)
    assert {t.device.type for _, t in leaves_with_paths(mp)} == {"meta"}
    assert _shapes(mp) == _shapes(rp)
    stacked = reg.stacked_names(meta.cfg)
    opt = get_optimizer(meta.cfg.optimizer)
    ms = make_train_state(mp, opt, stacked)
    rs = make_train_state(rp, opt, stacked)
    assert _shapes(ms.opt_state) == _shapes(rs.opt_state)
    assert _shapes(meta.init_cache(2, 16)) == _shapes(real.init_cache(2, 16))
    # the JAX paths: the state's tree names every leaf once, in JAX's order
    j_state = jax.eval_shape(
        lambda k: JTrainState(step=jnp.zeros((), jnp.int32), params=jreg.get_model(
            arch, smoke=True).init(k), opt_state=j_get_optimizer(meta.cfg.optimizer).init(
            jreg.get_model(arch, smoke=True).init(k))), jax.random.PRNGKey(0))
    j_paths = [(jshd._path_str(p), tuple(leaf.shape)) for p, leaf in
               jax.tree_util.tree_flatten_with_path(j_state)[0]]
    p_tree = reg.state_tree(ms, meta.cfg)
    assert [(p, tuple(t.shape)) for p, t in p_tree.items()] == j_paths
