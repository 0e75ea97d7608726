"""The order of ``coord_update``'s α additions, on the CPU.

The kernel adds line 26 in the plain version's order: every α[c] is
((α_old[c] + t₁) + t₂) + … over the rows of column j that hold c, in
ascending row order.  Its long route gets there by column owners (each touched
column walks its own rows, skipping non-members); ``scatter_alpha_owners``
states that order in plain PyTorch.  Here it is held bit for bit (sign of
zero included) to ``coord_update_ref``'s ``index_add_`` α on seeded problems
with a column in every row, several heavy columns, negative values and -0.0
entries in α, for every loss, flat and tiered layouts, private and not.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.losses import get_loss
from repro_torch.core.samplers.group_argmax import ga_init
from repro_torch.core.samplers.two_level import tl_init
from repro_torch.core.sparse import formats as tf
from repro_torch.kernels.coord_update import coord_update
from repro_torch.kernels.coord_update.ops import (WARP_OWNER_MAX, coord_update_scratch,
                                                  owner_table)
from repro_torch.kernels.coord_update.ref import (bitwise_rule_mismatches, coord_update_ref,
                                                  lane_terms, same_bits, scatter_alpha_owners,
                                                  scatter_alpha_rows)

LOSSES = ["logistic", "squared", "lad", "huber", "smoothed_hinge"]
N, D = 300, 400


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, size=(N, D)) * (rng.random((N, D)) < 0.05)
    x[:, 0] = rng.uniform(-1, 1, size=N) + np.sign(rng.uniform(-1, 1, size=N)) * 0.05
    for c in (3, 9, 27, 81):                            # heavy columns
        x[:, c] = rng.uniform(-1, 1, size=N) * (rng.random(N) < 0.6)
    x[:, 13] = 0.0                                      # an empty column
    pcsr, pcsc = tf.dense_to_padded(x, device="cpu")
    y = torch.from_numpy((rng.random(N) < 0.5).astype(np.float32))
    return x, pcsr, pcsc, y


def _state(seed):
    rng = np.random.default_rng(seed)
    alpha = rng.normal(0, 0.05, D).astype(np.float32)
    alpha[rng.random(D) < 0.15] = -0.0                  # -0.0 at touched columns too
    alpha[rng.random(D) < 0.05] = 0.0
    return dict(w=torch.from_numpy((rng.normal(0, 0.5, D) * (rng.random(D) < 0.2))
                                   .astype(np.float32)),
                w_m=torch.tensor(0.37), g_tilde=torch.tensor(0.8),
                vbar=torch.from_numpy(rng.normal(0, 1, N).astype(np.float32)),
                qbar=torch.from_numpy(rng.normal(0, 0.4, N).astype(np.float32)),
                alpha=torch.from_numpy(alpha))


def _gammas(j, pcsc, y, st, *, t, lam, inv_n, loss):
    """γᵢ/N of column j's lanes, by ``coord_update_ref``'s operations."""
    obj = get_loss(loss)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    a_j = st["alpha"][j]
    d_tilde = torch.where(a_j == 0, f32(lam), -f32(lam) * torch.sign(a_j))
    eta = f32(2.0) / (f32(t) + 2.0)
    wm = st["w_m"] * (1.0 - eta)
    rows, xv = pcsc.col_live(j)
    rows = rows.long()
    vb = st["vbar"][rows] + eta * d_tilde * xv / wm
    hm = obj.h(wm * vb, None if obj.separable else y[rows])
    return rows, (hm - st["qbar"][rows]) * inv_n


def _columns(x):
    nnz = (x != 0).sum(0)
    light = int(np.flatnonzero((nnz > 0) & (nnz <= 12))[0])
    return [0, 3, 81, int(np.argsort(nnz)[-10]), light, 13]


@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("layout", ["flat", "tiered"])
@pytest.mark.parametrize("loss", LOSSES)
def test_owner_order_equals_index_add_order(problem, loss, layout, private):
    x, pcsr, flat, y = problem
    pcsc = flat if layout == "flat" else tf.tiered_from_padded(flat, 10)
    em = 7.5 if private else 1.0
    assert int(flat.nnz[0]) == N and int((flat.nnz > 100).sum()) >= 5
    for case, j in enumerate(_columns(x)):
        before = _state(100 * case + len(loss))
        before["queue"] = tl_init(before["alpha"].abs() * em) if private \
            else ga_init(before["alpha"].abs())
        step = dict(t=4.0 + case, lam=8.0, inv_n=1.0 / N, em_scale=em, loss=loss)
        after = {k: v.clone() for k, v in before.items()}
        gaps, coords = torch.zeros(1), torch.zeros(1, dtype=torch.int32)
        coord_update_ref(torch.tensor([j], dtype=torch.int32), pcsr, pcsc, y, after["w"],
                         after["w_m"], after["g_tilde"], after["vbar"], after["qbar"],
                         after["alpha"], after["queue"], gaps=gaps, coords=coords, slot=0,
                         **step)
        rows, gs = _gammas(j, pcsc, y, before, t=step["t"], lam=8.0, inv_n=1.0 / N, loss=loss)
        msg = f"{loss} {layout} private={private} j={j}"
        assert same_bits(scatter_alpha_rows(before["alpha"], rows, gs, pcsr),
                          after["alpha"]), msg
        assert same_bits(scatter_alpha_owners(before["alpha"], rows, gs, pcsr, pcsc),
                          after["alpha"]), msg
        touched = torch.unique(lane_terms(rows, gs, pcsr)[0])
        if rows.numel():
            assert bool(torch.signbit(after["alpha"][touched]).any()), msg
        # the CPU's own step meets the rule the card's is held to
        after.update(gaps=gaps, coords=coords)
        assert bitwise_rule_mismatches(j, pcsr, pcsc, y, before, after, gs, **step) == [], msg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_owner_order_keeps_negative_zero(problem, seed):
    """Members whose term is ±0 are added; non-members are skipped, not added
    as +0 (a walk that did would turn -0.0 into +0.0)."""
    _, pcsr, pcsc, _ = problem
    rng = np.random.default_rng(seed)
    rows = torch.from_numpy(np.sort(rng.choice(N, 40, replace=False)))
    gs = torch.from_numpy(rng.normal(0, 1e-3, 40).astype(np.float32))
    gs[::3] = 0.0
    gs[1::3] = -0.0
    alpha = torch.from_numpy(rng.normal(0, 0.05, D).astype(np.float32))
    alpha[rng.random(D) < 0.5] = -0.0
    want = scatter_alpha_rows(alpha, rows, gs, pcsr)
    got = scatter_alpha_owners(alpha, rows, gs, pcsr, pcsc)
    assert same_bits(got, want)
    touched = torch.unique(lane_terms(rows, gs, pcsr)[0])
    neg_zero = touched[(want[touched] == 0) & torch.signbit(want[touched])]
    assert neg_zero.numel() > 0                 # the case the rule is about is present
    assert bool(((want[neg_zero] + 0.0) == 0).all()) and \
        not bool(torch.signbit(want[neg_zero] + 0.0).any())   # +0 would flip each one


def _cpu_step(problem, j, private):
    x, pcsr, pcsc, y = problem
    before = _state(5)
    before["queue"] = tl_init(before["alpha"].abs() * 7.5) if private \
        else ga_init(before["alpha"].abs())
    step = dict(t=6.0, lam=8.0, inv_n=1.0 / N, em_scale=7.5 if private else 1.0,
                loss="logistic")
    after = {k: v.clone() for k, v in before.items()}
    after.update(gaps=torch.zeros(1), coords=torch.zeros(1, dtype=torch.int32))
    coord_update_ref(torch.tensor([j], dtype=torch.int32), pcsr, pcsc, y, after["w"],
                     after["w_m"], after["g_tilde"], after["vbar"], after["qbar"],
                     after["alpha"], after["queue"], gaps=after["gaps"],
                     coords=after["coords"], slot=0, **step)
    _, gs = _gammas(j, pcsc, y, before, t=6.0, lam=8.0, inv_n=1.0 / N, loss="logistic")
    return before, after, gs, step


@pytest.mark.parametrize("private", [False, True])
def test_bitwise_rule_flags_an_ulp(problem, private):
    _, pcsr, pcsc, y = problem
    before, after, gs, step = _cpu_step(problem, 3, private)
    c = int(lane_terms(pcsc.col_live(3)[0], gs, pcsr)[0][0])
    for name, idx in (("alpha", c), ("vbar", int(pcsc.col_live(3)[0][0]))):
        off = {k: v.clone() for k, v in after.items()}
        off[name][idx] = torch.nextafter(off[name][idx], torch.tensor(1.0))
        assert name in bitwise_rule_mismatches(3, pcsr, pcsc, y, before, off, gs, **step)
    off = {k: v.clone() for k, v in after.items()}
    prio = off["queue"].v if private else off["queue"].p
    prio.view(-1)[c] = prio.view(-1)[c] * 2
    assert "prio" in bitwise_rule_mismatches(3, pcsr, pcsc, y, before, off, gs, **step)
    assert bitwise_rule_mismatches(3, pcsr, pcsc, y, before, after, gs[:-1], **step) == ["gs"]


@pytest.mark.parametrize("layout", ["flat", "tiered"])
def test_owner_table_lists_long_columns_and_checks_row_order(problem, layout):
    _, pcsr, flat, _ = problem
    pcsc = flat if layout == "flat" else tf.tiered_from_padded(flat, 10)
    owners = owner_table(pcsc)
    table, nnz = owners.heavy, flat.nnz
    assert table.dtype == torch.int32
    assert sorted(table.tolist()) == torch.nonzero(nnz > WARP_OWNER_MAX).flatten().tolist()
    assert table.numel() >= 1 and int(table[0]) == 0             # the longest first
    assert bool((nnz[table.long()].diff() <= 0).all())
    assert owners.slots == table.numel()                          # all fit at this size
    kind, counts = owners.col_info[:, 0], owners.col_info[:, 1]
    assert kind[table.long()].tolist() == list(range(owners.slots))
    assert int((kind >= 0).sum()) == owners.slots and torch.equal(counts, nnz)
    assert bool((kind[nnz <= WARP_OWNER_MAX] == -1).all())
    assert owner_table(pcsc) is owners                            # built once
    swapped = tf.PaddedCSC(flat.indices.clone(), flat.values.clone(), flat.nnz, flat.shape)
    swapped.indices[3, [1, 2]] = swapped.indices[3, [2, 1]]       # rows out of order
    if layout == "tiered":
        swapped = tf.tiered_from_padded(swapped, 10)
    with pytest.raises(ValueError, match="ascending"):
        owner_table(swapped)


def test_scratch_and_route_arguments(problem):
    _, pcsr, pcsc, y = problem
    s = coord_update_scratch(N, D, "cpu")
    assert s.gs.shape == s.parts.shape == (N,) and s.rowinfo.shape == (N, 2)
    assert s.colstamp.shape == (D,) and s.routes.tolist() == [0, 0] and s.epoch == 0
    st = _state(1)
    with pytest.raises(ValueError, match="route"):
        coord_update(torch.tensor([0], dtype=torch.int32), pcsr, pcsc, y, st["w"], st["w_m"],
                     st["g_tilde"], st["vbar"], st["qbar"], st["alpha"],
                     ga_init(st["alpha"].abs()), t=1.0, lam=1.0, inv_n=1.0 / N,
                     em_scale=1.0, loss="logistic", gaps=torch.zeros(1),
                     coords=torch.zeros(1, dtype=torch.int32), slot=0, route="fastest")
