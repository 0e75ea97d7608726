"""The in-order scatter-add (``kernels/scatter``): its plain version against
the JAX package's ``.at[idx].add`` on the CPU, bit for bit.

The kernel on the card adds each target's live lanes in input order, as one
float32 chain onto ``dst``; its plain version states that order with
``index_add_`` (a serial loop on the CPU).  These tests hold the plain
version to XLA's CPU scatter and to ``numpy.add.at`` bit for bit, on inputs
whose sums depend on the order: heavily repeated targets, terms spread over
16 decades, dead lanes (dropped by JAX as out-of-range indices) and ``-0.0``
in both ``dst`` and ``src``; and on the table of contract cases
(``kernels/scatter/cases.py``: every lane dead, ``live=None``, int32 and
int64 indices, dead lanes holding -1, n or 2^31 - 1, one target taking
70,000 lanes onto -0.0, 2-D lanes as ``lane_scatter`` passes them, no
lanes), which the card's test runs against the kernel.  They also pin the
fact the plain version is built on: ``index_put_(accumulate=True)`` is not in input order on the CPU
from 32,768 lanes on (parallel atomics), ``index_add_`` is.  The kernel
itself is held to the plain version on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``'s ``scatter_vs_plain``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.fw_torch import scatter_add
from repro_torch.kernels import launch_counts
from repro_torch.kernels.scatter import scatter_add_ordered
from repro_torch.kernels.scatter.cases import CASES as CONTRACT_CASES, jax_indices
from repro_torch.kernels.scatter.cases import power_law as _case
from repro_torch.kernels.scatter.ref import scatter_add_ordered_ref


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


CASES = [(0, 7, 300, 0.0), (1, 50, 5000, 0.3), (2, 1000, 40000, 0.5), (3, 3, 70000, 0.1)]


@pytest.mark.parametrize("seed,n,k,dead", CASES)
def test_plain_version_equals_jax_scatter_add_bitwise(seed, n, k, dead):
    dst, idx, src, live = _case(seed, n, k, dead)
    # JAX drops a scatter lane whose index is out of range: the dead lanes
    jax_idx = np.where(live, idx, n + 5).astype(np.int32)
    want = jnp.asarray(dst).at[jnp.asarray(jax_idx)].add(jnp.asarray(src))
    got = scatter_add_ordered_ref(torch.from_numpy(dst), torch.from_numpy(idx),
                                  torch.from_numpy(src), torch.from_numpy(live))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(want)))
    np.add.at(dst, idx[live], src[live])
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(dst))


@pytest.mark.parametrize("seed,n,k,dead", CASES[:2])
def test_wrapper_and_scatter_add_run_the_plain_version_on_the_cpu(seed, n, k, dead):
    dst, idx, src, live = _case(seed, n, k, dead)
    args = [torch.from_numpy(a) for a in (dst, idx, src, live)]
    before = launch_counts()["scatter_add_ordered"]
    want = scatter_add_ordered_ref(*args)
    for got in (scatter_add_ordered(*args), scatter_add(*args),
                scatter_add_ordered(args[0], args[1].int(), args[2], args[3])):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    assert launch_counts()["scatter_add_ordered"] == before    # no kernel on the CPU
    all_live = scatter_add_ordered(args[0], args[1], args[2])
    np.testing.assert_array_equal(
        _bits(all_live.numpy()),
        _bits(scatter_add_ordered_ref(args[0], args[1], args[2], torch.ones(k, dtype=bool))))
    assert torch.equal(args[0], torch.from_numpy(dst))         # functional


@pytest.mark.parametrize("name", sorted(CONTRACT_CASES))
def test_contract_case_plain_version_equals_jax_bitwise(name):
    """Each contract case: the plain version, the wrapper and ``scatter_add``
    on the CPU equal JAX's ``.at[].add`` bit for bit and launch no kernel."""
    dst, idx, src, live = CONTRACT_CASES[name]()
    jax_idx = jax_indices(idx, live, dst.size).astype(np.int32)
    want = _bits(np.asarray(jnp.asarray(dst).at[jnp.asarray(jax_idx)].add(jnp.asarray(src))))
    args = [torch.from_numpy(dst), torch.from_numpy(idx), torch.from_numpy(src),
            None if live is None else torch.from_numpy(live)]
    before = launch_counts()["scatter_add_ordered"]
    for fn in (scatter_add_ordered_ref, scatter_add_ordered, scatter_add):
        np.testing.assert_array_equal(_bits(fn(*args).numpy()), want)
    assert launch_counts()["scatter_add_ordered"] == before
    assert torch.equal(args[0], torch.from_numpy(dst))         # functional


def test_plain_version_takes_2d_lanes_and_refuses_the_card():
    dst, idx, src, live = _case(4, 30, 600, 0.2)
    shape = (20, 30)
    got = scatter_add_ordered_ref(torch.from_numpy(dst), torch.from_numpy(idx).reshape(shape),
                                  torch.from_numpy(src).reshape(shape),
                                  torch.from_numpy(live).reshape(shape))
    flat = scatter_add_ordered_ref(torch.from_numpy(dst), torch.from_numpy(idx),
                                   torch.from_numpy(src), torch.from_numpy(live))
    assert torch.equal(got, flat)
    with pytest.raises(ValueError, match="CPU"):
        scatter_add_ordered_ref(torch.zeros(3, device="meta"), torch.zeros(2, dtype=torch.long),
                                torch.zeros(2))


def test_cpu_index_put_accumulate_is_not_input_order_but_index_add_is():
    """Why the plain version is ``index_add_``: at 2^20 lanes onto 5 targets
    ``index_put_(accumulate=True)`` adds with parallel atomics when torch has
    more than one thread."""
    if torch.get_num_threads() < 2:
        pytest.skip("one CPU thread: index_put_ runs serially")
    dst, idx, src, _ = _case(5, 5, 1 << 20, 0.0)
    want = dst.copy()
    np.add.at(want, idx, src)
    t = torch.from_numpy(dst.copy())
    t.index_add_(0, torch.from_numpy(idx), torch.from_numpy(src))
    np.testing.assert_array_equal(_bits(t.numpy()), _bits(want))
    put = torch.from_numpy(dst.copy())
    put.index_put_((torch.from_numpy(idx),), torch.from_numpy(src), accumulate=True)
    assert (_bits(put.numpy()) != _bits(want)).any()
