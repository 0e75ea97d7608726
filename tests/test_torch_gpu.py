"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips without a CUDA card (decided in the fixture,
not at import).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports neither JAX nor the JAX package: the card's machine has
neither.  Tolerances: kernel against plain version allclose at rtol 1e-5 /
atol 1e-6 (the plain versions add with atomics, in another order); draws
equal index for index; the card's solve against the CPU's (plain versions)
by the cross-engine contract — coordinates exactly, w and gaps within 1e-4.
``ell_rmatvec`` also equals its plain version run on the CPU bit for bit
(both add in the segmented row order, ``spmv/ref.py``), and ``coord_update``
meets its bitwise rule against the CPU (``coord_update/ref.py``), on both
of its routes.  Flash attention
against the materialised oracle on the card: 2e-5 in float32 (the CUDA-core
route) and 0.06 in bfloat16 (the tensor-core route; ``tests/test_kernels.py``'s
bounds); each ported arch's smoke LM (the dense ones, MLA and MoE) has its
forward on the card against the CPU's within 1e-4, every MoE layer routing
each token to the CPU's experts, decode against forward within 5e-4
(``tests/test_models_smoke.py``'s bound); MLA and MoE batched decode steps
with a position per row equal per-row decodes on the card; and the serving
engine's greedy tokens equal to the CPU engine's.  A dataset store solved on
the card equals the in-memory solve on the card bit for bit, cold and warm,
and its setup cache is the card's own file.  The lane kernels (a sweep
group's B configs in one launch) at B = 1, 3 and 8 equal the single-config
kernel run on each lane bit for bit — lanes on different routes, a lane
that is done — and meet the kernels' rules against the plain versions;
every lane's arrival counter is 0 after each launch; ``solve_many`` on the
card equals per-config ``solve`` bit for bit with one launch of each kernel
per step for the whole group.  A screened solve on the card takes the CPU's
coordinates and survivor sets (w and gaps within 1e-4), a forced keep-all
round keeps the card's bits, ``coord_update`` on a repacked pair meets its
bitwise rule on both routes, and a λ-path group as lanes equals the
per-config path drivers bit for bit.  ``torch_dense`` on the card (both
tiles, five losses) launches only its setup's ``ell_rmatvec`` and, private,
the draw kernel's rebuild once a step, repeats its bits run to run, and
takes the CPU's and ``torch_sparse``'s coordinates (w and gaps within 1e-4);
the eager oracle launches nothing and takes ``torch_sparse``'s coordinates;
``host_sparse`` returns the CPU's result as tensors on the card; the fit
service's answers equal their own ``solve`` bit for bit.  The in-order
scatter kernel equals its plain version on the CPU bit for bit, so
``torch_dense``'s card w equals the CPU's; flash attention pads head dims
outside its table (18, 24, 112, and 192 against a v head dim of 128) within
the same bounds; ``jax_shard`` on a 1×1 grid takes the CPU's coordinates and
w bit for bit, launching only the scatter kernel.  Flash attention also runs
non-causal with q and k of different lengths (encdec's cross-attention, hd
64 and 128) and at recurrentgemma's local shape (window 2,048 over S =
4,096, hd 256, one kv head); mamba's, rglru's and encdec's smoke LMs have
their forward on the card against the CPU's within 1e-4, and their decode ≡
forward within 5e-4, rglru's ring and a windowed dense config's past the
window.  Training: the attention backward kernel against its plain version
(float32 within 2e-5 of max |plain|, bf16 by the forward's two bounds) at
causal GQA, ragged, cross, window, MLA and hd 112 shapes, the log-sum-exp
output leaving the forward's out bit for bit and the backward's bits equal
launch to launch; autograd through the op launches both kernels; one
float32 training step of five families' smoke LMs on the card against the
CPU (loss 1e-5 relative, grad_norm 1e-4 relative, each gradient leaf 5e-4
of its max).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import FWConfig, grid, prng, solve, solve_many
from repro_torch.core.samplers.group_argmax import ga_init
from repro_torch.core.samplers.two_level import (rebuild_groups_, tl_init, tl_rebuild_,
                                                 tl_scatter_)
from repro_torch.core.solvers.torch_sparse import fw_setup
from repro_torch.core.sparse.formats import PaddedCSR, host_to_padded, tiered_from_padded
from repro_torch.data.synthetic import make_sparse_classification, with_repeated_entries
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.bsls_draw import two_level_draw, two_level_draw_lanes
from repro_torch.kernels.bsls_draw.ops import arrival_counter, key_table
from repro_torch.kernels.bsls_draw.ref import two_level_draw_ref
from repro_torch.kernels.coord_update import coord_update, coord_update_lanes
from repro_torch.kernels.coord_update import ops as cu_ops
from repro_torch.kernels.coord_update.ops import (coord_update_scratch, lane_scalars,
                                                  short_route_max_rows)
from repro_torch.kernels.coord_update.ref import (bitwise_rule_mismatches, coord_update_ref,
                                                  same_bits)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import common as model_common
from repro_torch.models.flash import flash_attention as flash_attention_plain
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
from repro_torch.kernels.spmv import ell_matvec, ell_rmatvec
from repro_torch.kernels.spmv.ref import SEGMENT, ell_matvec_ref, ell_rmatvec_ref, segments

pytestmark = pytest.mark.gpu
LOSSES = ["logistic", "squared", "lad", "huber", "smoothed_hinge"]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def problem(cuda):
    X, y, _ = make_sparse_classification(n=600, d=2000, nnz_per_row=12, informative=20,
                                         seed=3)
    return X, y, host_to_padded(X, device=cuda)


def test_ell_rmatvec_kernel_matches_plain(problem):
    X, _, (pcsr, pcsc) = problem
    assert int(pcsc.nnz.max()) > SEGMENT                          # a column of segments
    q = torch.randn(X.shape[0], generator=torch.Generator().manual_seed(0)).cuda()
    before = launch_counts()["ell_rmatvec"]
    got = ell_rmatvec(pcsr, q, pcsc)
    assert launch_counts()["ell_rmatvec"] == before + 1
    ref = ell_rmatvec_ref(pcsr.indices, pcsr.values, q, segments(pcsr))
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)   # card plain: atomics
    cpu = pcsr.to("cpu")                                          # CPU plain: the same order
    assert torch.equal(got.cpu(), ell_rmatvec_ref(cpu.indices, cpu.values, q.cpu(),
                                                  segments(cpu)))
    assert torch.equal(got, ell_rmatvec(pcsr, q, pcsc))          # deterministic
    tiered = tiered_from_padded(pcsc, 8)
    assert torch.equal(got, ell_rmatvec(pcsr, q, tiered))        # same sums, same order
    with pytest.raises(ValueError, match="pcsc"):
        ell_rmatvec(pcsr, q)


def test_ell_matvec_kernel_matches_plain(problem):
    X, _, (pcsr, _) = problem
    w = torch.randn(X.shape[1], generator=torch.Generator().manual_seed(1)).cuda()
    w[::4] = 0.0
    before = launch_counts()["ell_matvec"]
    got = ell_matvec(pcsr, w)
    assert launch_counts()["ell_matvec"] == before + 1
    ref = ell_matvec_ref(pcsr.indices, pcsr.values, w)
    scale = ell_matvec_ref(pcsr.indices, pcsr.values.abs(), w.abs())
    assert bool(((got - ref).abs() <= 1e-5 * scale + 1e-7).all())
    assert torch.equal(got, ell_matvec(pcsr, w))                  # deterministic
    with pytest.raises(ValueError, match="float32"):
        ell_matvec(pcsr, w[:-1])


def test_two_level_draw_kernel_matches_plain(problem):
    X, y, (pcsr, pcsc) = problem
    alpha = fw_setup(pcsr, torch.from_numpy(y.astype(np.float32)).cuda(), loss="logistic",
                     pcsc=pcsc)[2]
    state = tl_init(alpha.abs() * 200.0)
    _, keys = prng.key_chain(prng.PRNGKey(1), 300)
    for k in keys:
        assert int(two_level_draw(state.c, state.v, k)) == int(two_level_draw_ref(
            state.c, state.v, k)), k


@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("loss", LOSSES)
def test_coord_update_kernel_matches_plain(problem, loss, private):
    X, y, (pcsr, pcsc) = problem
    y_t = torch.from_numpy(y.astype(np.float32)).cuda()
    setup = fw_setup(pcsr, y_t, loss=loss, pcsc=pcsc)
    col_nnz = pcsc.nnz.cpu().numpy()
    for j in (int(np.argmax(col_nnz)), int(np.argmin(np.where(col_nnz > 0, col_nnz, 99))),
              int(np.argsort(col_nnz)[-40])):
        outs = []
        for fn in (coord_update, coord_update_ref):
            st = [t.clone() for t in setup] + [torch.zeros(X.shape[1], device="cuda"),
                                               torch.tensor(0.8, device="cuda"),
                                               torch.tensor(0.5, device="cuda")]
            vbar, qbar, alpha, w, w_m, g_tilde = st
            queue = tl_init(alpha.abs() * 30.0) if private else ga_init(alpha.abs())
            gaps = torch.zeros(2, device="cuda")
            coords = torch.zeros(2, dtype=torch.int32, device="cuda")
            fn(torch.tensor([j], dtype=torch.int32, device="cuda"), pcsr, pcsc, y_t, w, w_m,
               g_tilde, vbar, qbar, alpha, queue, t=4.0, lam=8.0, inv_n=1.0 / X.shape[0],
               em_scale=30.0, loss=loss, gaps=gaps, coords=coords, slot=1)
            if private:
                tl_rebuild_(queue)
            outs.append(st + [gaps, coords.float()] +
                        ([queue.v, queue.c] if private else [queue.p, queue.bound]))
        for a, b in zip(*outs):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def long_problem(cuda):
    """Columns of a few thousand rows (the longest 2,828 of 3,000), so the
    long route runs on them."""
    X, y, _ = make_sparse_classification(n=3000, d=2500, nnz_per_row=16, informative=20,
                                         seed=5)
    return X, y, host_to_padded(X, device=cuda)


def _card_step(j, pcsr, pcsc, y_t, base, step, scratch, route):
    st = {k: v.clone() for k, v in base.items()}
    gaps = torch.zeros(2, device="cuda")
    coords = torch.zeros(2, dtype=torch.int32, device="cuda")
    coord_update(torch.tensor([j], dtype=torch.int32, device="cuda"), pcsr, pcsc, y_t,
                 st["w"], st["w_m"], st["g_tilde"], st["vbar"], st["qbar"], st["alpha"],
                 st["queue"], gaps=gaps, coords=coords, slot=1, scratch=scratch, route=route,
                 **step)
    st.update(gaps=gaps[1:], coords=coords[1:])
    return st


def _bits(st) -> list:
    q = st["queue"]
    out = [st[k] for k in ("w", "w_m", "g_tilde", "vbar", "qbar", "alpha", "gaps", "coords")]
    return out + ([q.v, q.c, q.touched] if hasattr(q, "c") else [q.p, q.bound])


def _same_bits(a: list, b: list) -> bool:
    return all(map(same_bits, a, b))


@pytest.mark.parametrize("layout", ["flat", "tiered"])
@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("loss", LOSSES)
def test_coord_update_kernel_bitwise_rule(problem, long_problem, loss, private, layout,
                                          monkeypatch):
    """The card's step against the CPU by the kernel's bitwise rule
    (``ref.bitwise_rule_mismatches``) on the heaviest, a p99 and a light
    column of both problems; the short and the long route forced on the same
    column and a second launch give the same bits; flat = tiered, and the
    long route without lane-term slots = with them."""
    for X, y, (pcsr, flat) in (problem, long_problem):
        n, d = X.shape
        pcsc = flat if layout == "flat" else tiered_from_padded(flat, 8)
        y_t = torch.from_numpy(y.astype(np.float32)).cuda()
        vbar, qbar, alpha = fw_setup(pcsr, y_t, loss=loss, pcsc=flat)
        gen = torch.Generator().manual_seed(7)
        w = (torch.randn(d, generator=gen) * (torch.rand(d, generator=gen) < 0.2)).cuda()
        alpha[::7] = -0.0
        em = 30.0 if private else 1.0
        base = dict(w=w, w_m=torch.tensor(0.8, device="cuda"),
                    g_tilde=torch.tensor(0.5, device="cuda"), vbar=vbar, qbar=qbar,
                    alpha=alpha, queue=tl_init(alpha.abs() * em) if private
                    else ga_init(alpha.abs()))
        before = {k: (v.to("cpu"))
                  for k, v in base.items()}
        step = dict(t=4.0, lam=8.0, inv_n=1.0 / n, em_scale=em, loss=loss)
        cpu_csr, cpu_csc, y_cpu = pcsr.to("cpu"), pcsc.to("cpu"), y_t.cpu()
        col_nnz = flat.nnz.cpu().numpy()
        live = np.flatnonzero(col_nnz > 0)
        scratch = coord_update_scratch(n, d, "cuda")
        for j in (int(np.argmax(col_nnz)), int(live[np.argmin(col_nnz[live])]),
                  int(np.argsort(col_nnz)[-max(1, d // 100)])):
            card = _card_step(j, pcsr, pcsc, y_t, base, step, scratch, "auto")
            k = int(col_nnz[j])
            after = {key: (v.to("cpu"))
                     for key, v in card.items()}
            bad = bitwise_rule_mismatches(j, cpu_csr, cpu_csc, y_cpu, before, after,
                                          scratch.gs[:k].cpu(), **step)
            assert bad == [], (n, j, k, bad)
            for route in ("short", "long", "auto"):
                again = _card_step(j, pcsr, pcsc, y_t, base, step, scratch, route)
                assert _same_bits(_bits(card), _bits(again)), (n, j, route)
            other = flat if layout == "tiered" else tiered_from_padded(flat, 8)
            assert _same_bits(_bits(card), _bits(_card_step(j, pcsr, other, y_t, base, step,
                                                            scratch, "auto")))
            # no lane-term slots: every heavy owner walks its own rows
            monkeypatch.setattr(cu_ops, "LANE_TERMS_MAX", 0)
            bare = pcsc.to("cuda")
            assert cu_ops.owner_table(bare).slots == 0
            assert _same_bits(_bits(card), _bits(_card_step(j, pcsr, bare, y_t, base, step,
                                                            scratch, "long")))
            monkeypatch.undo()
    assert int(long_problem[2][1].nnz.max()) >= 2000 > short_route_max_rows()
    assert int(scratch.routes[1]) > 0 and int(scratch.routes[0]) > 0


@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("loss", LOSSES)
def test_card_solve_matches_cpu_solve(problem, loss, private):
    X, y, pair = problem
    cfg = FWConfig(backend="torch_sparse", lam=8.0, steps=40, loss=loss,
                   queue="two_level" if private else None)
    reset_launch_counts()
    card = solve(pair, y, cfg)
    counts = launch_counts()
    assert counts["coord_update"] == 40
    assert counts["two_level_draw"] == (40 if private else 0)
    assert two_level_draw.rebuilds == (1 if private else 0)   # after the chunk's last step
    assert counts["ell_rmatvec"] == (2 if loss in ("logistic", "squared") else 1)
    cpu = solve(X, y, dataclasses.replace(cfg, device="cpu"))
    assert torch.equal(card.coords.cpu(), cpu.coords)
    torch.testing.assert_close(card.w.cpu(), cpu.w, rtol=0, atol=1e-4)
    torch.testing.assert_close(card.gaps.cpu(), cpu.gaps, rtol=0, atol=1e-4)
    again = solve(pair, y, cfg)
    assert torch.equal(again.w, card.w) and torch.equal(again.coords, card.coords)
    tiered = solve((pair[0], tiered_from_padded(pair[1], 8)), y, cfg)
    assert torch.equal(tiered.coords, card.coords)


@pytest.mark.parametrize("selection", ["argmax", "noisy_max", "gumbel"])
def test_dense_card_solve_matches_cpu_solve(problem, selection):
    X, y, pair = problem
    cfg = FWConfig(backend="dense", lam=8.0, steps=40, selection=selection, epsilon=20.0)
    reset_launch_counts()
    card = solve(pair, y, cfg)
    assert launch_counts() == {"ell_matvec": 40, "ell_rmatvec": 41, "two_level_draw": 0,
                               "coord_update": 0, "flash_attention": 0,
                               "flash_attention_bwd": 0, "two_level_draw_lanes": 0,
                               "coord_update_lanes": 0, "scatter_add_ordered": 0}
    cpu = solve(X, y, dataclasses.replace(cfg, device="cpu"))
    assert torch.equal(card.coords.cpu(), cpu.coords)
    for name in ("w", "gaps", "losses"):
        torch.testing.assert_close(getattr(card, name).cpu(), getattr(cpu, name), rtol=0,
                                   atol=1e-4)
    again = solve(pair, y, cfg)
    assert torch.equal(again.w, card.w) and torch.equal(again.coords, card.coords)
    if selection == "argmax":
        dense = solve(X, y, cfg)               # HostCSR → dense (N, D) on the card
        assert torch.equal(dense.coords, card.coords)
        torch.testing.assert_close(dense.w, card.w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("backend,queue", [("dense", None), ("torch_sparse", "group_argmax"),
                                           ("torch_sparse", "two_level")])
def test_masked_card_run_is_prefix_of_fixed_run(problem, backend, queue):
    X, y, pair = problem
    cfg = FWConfig(backend=backend, lam=8.0, steps=60, queue=queue, chunk_steps=16)
    full = solve(pair, y, cfg)
    # the first positive gap from T/2 on (a private trace may dip below zero)
    k = next(i for i in range(30, 60) if float(full.gaps[i]) > 0)
    stopped = solve(pair, y, dataclasses.replace(cfg, gap_tol=float(full.gaps[k])))
    stop = stopped.stop_step_or()
    assert stopped.stop_reason == "gap_tol" and 0 < stop <= k + 1
    assert torch.equal(stopped.coords[:stop], full.coords[:stop])
    assert torch.equal(stopped.gaps[:stop], full.gaps[:stop])
    assert bool((stopped.coords[stop:] == -1).all())


@pytest.fixture(scope="module")
def repeated_problem(cuda):
    """``long_problem``'s matrix with repeated entries (a row that lists a
    column twice): three on the longest column (2,828 rows), three on a p99
    column (282 rows, over warp_owner_max), one on a light column, and 40
    anywhere."""
    X, y, _ = make_sparse_classification(n=3000, d=2500, nnz_per_row=16, informative=20,
                                         seed=5)
    csc = X.tocsc()
    col_nnz = np.diff(csc.indptr)
    rng = np.random.default_rng(8)
    order = np.argsort(col_nnz, kind="stable")
    cols = dict(head=int(order[-1]), p99=int(order[-25]),
                light=int(np.flatnonzero((col_nnz >= 3) & (col_nnz <= 8))[0]))
    rows, picked = [], []
    for c, k in ((cols["head"], 3), (cols["p99"], 3), (cols["light"], 1)):
        rows += list(rng.choice(csc.indices[csc.indptr[c]:csc.indptr[c + 1]], k, replace=False))
        picked += [c] * k
    for i in rng.choice(X.shape[0], 40, replace=False):
        rows.append(int(i))
        picked.append(int(rng.choice(X.row(int(i))[0])))
    Xr = with_repeated_entries(X, rows, picked, seed=9)
    return Xr, y, host_to_padded(Xr, device=cuda), cols


@pytest.mark.parametrize("layout", ["flat", "tiered"])
@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("loss", LOSSES)
def test_coord_update_bitwise_rule_with_repeated_entries(repeated_problem, loss, private,
                                                         layout):
    """The kernel's bitwise rule against the CPU where column j lists a row
    twice (the head, a p99 and a light column) and where it does not but
    its rows list columns twice; both routes and a rerun give the same bits."""
    X, y, (pcsr, flat), cols = repeated_problem
    n, d = X.shape
    pcsc = flat if layout == "flat" else tiered_from_padded(flat, 8)
    owners = cu_ops.owner_table(pcsc)
    assert all(int(owners.col_repeats[c]) == 1 for c in cols.values())
    assert int(flat.nnz[cols["p99"]]) > cu_ops.WARP_OWNER_MAX
    y_t = torch.from_numpy(y.astype(np.float32)).cuda()
    vbar, qbar, alpha = fw_setup(pcsr, y_t, loss=loss, pcsc=flat)
    gen = torch.Generator().manual_seed(3)
    w = (torch.randn(d, generator=gen) * (torch.rand(d, generator=gen) < 0.2)).cuda()
    alpha[::7] = -0.0
    em = 30.0 if private else 1.0
    base = dict(w=w, w_m=torch.tensor(0.8, device="cuda"),
                g_tilde=torch.tensor(0.5, device="cuda"), vbar=vbar, qbar=qbar, alpha=alpha,
                queue=tl_init(alpha.abs() * em) if private else ga_init(alpha.abs()))
    before = {k: v.to("cpu") for k, v in base.items()}
    step = dict(t=4.0, lam=8.0, inv_n=1.0 / n, em_scale=em, loss=loss)
    cpu_csr, cpu_csc, y_cpu = pcsr.to("cpu"), pcsc.to("cpu"), y_t.cpu()
    # the longest column without a repeated row whose rows list a column twice
    rows_repeat = owners.row_repeats.bool()
    cands = torch.nonzero(owners.col_repeats == 0).flatten()
    cands = cands[torch.argsort(flat.nnz[cands], descending=True, stable=True)]
    plain = next(int(c) for c in cands
                 if bool(rows_repeat[flat.col_live(int(c))[0].long()].any()))
    scratch = coord_update_scratch(n, d, "cuda")
    for j in (*cols.values(), plain):
        card = _card_step(j, pcsr, pcsc, y_t, base, step, scratch, "auto")
        k = int(flat.nnz[j])
        after = {key: v.to("cpu") for key, v in card.items()}
        bad = bitwise_rule_mismatches(j, cpu_csr, cpu_csc, y_cpu, before, after,
                                      scratch.gs[:k].cpu(), **step)
        assert bad == [], (j, k, bad)
        for route in ("short", "long", "auto"):
            again = _card_step(j, pcsr, pcsc, y_t, base, step, scratch, route)
            assert _same_bits(_bits(card), _bits(again)), (j, route)


@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("loss", LOSSES)
def test_card_solve_with_repeated_entries_matches_cpu_solve(repeated_problem, loss, private):
    X, y, pair, _ = repeated_problem
    cfg = FWConfig(backend="torch_sparse", lam=8.0, steps=40, loss=loss,
                   queue="two_level" if private else None)
    card = solve(pair, y, cfg)
    cpu = solve(X, y, dataclasses.replace(cfg, device="cpu"))
    assert torch.equal(card.coords.cpu(), cpu.coords)
    assert torch.equal(card.w.cpu(), cpu.w)
    torch.testing.assert_close(card.gaps.cpu(), cpu.gaps, rtol=0, atol=1e-4)
    if not private:   # the exact argmax picks dense columns, which list a row twice
        repeats = cu_ops.owner_table(pair[1]).col_repeats
        assert int(repeats[card.coords.long()].sum()) > 0


@pytest.fixture(scope="module")
def longer_than_n_problem(cuda):
    """The longest column (367 of 400 rows) listing 63 of its rows twice:
    more lanes (430) than the matrix has rows."""
    X, y, _ = make_sparse_classification(n=400, d=600, nnz_per_row=12, informative=10,
                                         seed=6)
    head = int(np.argmax(np.bincount(X.indices, minlength=X.shape[1])))
    holders = [i for i in range(X.shape[0]) if head in X.row(i)[0]]
    extra = X.shape[0] + 30 - len(holders)
    rows = np.random.default_rng(1).choice(holders, extra, replace=False)
    Xr = with_repeated_entries(X, rows, [head] * extra, seed=2)
    return Xr, y, host_to_padded(Xr, device=cuda), head


@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("loss", ["logistic", "squared"])
def test_coord_update_on_a_column_longer_than_n(longer_than_n_problem, loss, private):
    X, y, (pcsr, pcsc), head = longer_than_n_problem
    n, d = X.shape
    owners = cu_ops.owner_table(pcsc)
    assert int(pcsc.nnz[head]) == n + 30 == owners.lanes and owners.slots > 0
    y_t = torch.from_numpy(y.astype(np.float32)).cuda()
    vbar, qbar, alpha = fw_setup(pcsr, y_t, loss=loss, pcsc=pcsc)
    em = 30.0 if private else 1.0
    base = dict(w=torch.zeros(d, device="cuda"), w_m=torch.tensor(0.8, device="cuda"),
                g_tilde=torch.tensor(0.5, device="cuda"), vbar=vbar, qbar=qbar, alpha=alpha,
                queue=tl_init(alpha.abs() * em) if private else ga_init(alpha.abs()))
    before = {k: v.to("cpu") for k, v in base.items()}
    step = dict(t=4.0, lam=8.0, inv_n=1.0 / n, em_scale=em, loss=loss)
    scratch = coord_update_scratch(n, d, "cuda")
    light = int(torch.nonzero((pcsc.nnz > 2) & (pcsc.nnz < 10)).flatten()[0])
    for j in (head, light):
        card = _card_step(j, pcsr, pcsc, y_t, base, step, scratch, "auto")
        after = {key: v.to("cpu") for key, v in card.items()}
        k = int(pcsc.nnz[j])
        bad = bitwise_rule_mismatches(j, pcsr.to("cpu"), pcsc.to("cpu"), y_t.cpu(), before,
                                      after, scratch.gs[:k].cpu(), **step)
        assert bad == [], (j, bad)
        for route in ("short", "long"):
            again = _card_step(j, pcsr, pcsc, y_t, base, step, scratch, route)
            assert _same_bits(_bits(card), _bits(again)), (j, route)
    assert scratch.gs.shape[0] >= n + 30
    cfg = FWConfig(backend="torch_sparse", lam=8.0, steps=30, loss=loss,
                   queue="two_level" if private else None)
    card = solve((pcsr, pcsc), y, cfg)
    cpu = solve(X, y, dataclasses.replace(cfg, device="cpu"))
    assert torch.equal(card.coords.cpu(), cpu.coords) and torch.equal(card.w.cpu(), cpu.w)
    torch.testing.assert_close(card.gaps.cpu(), cpu.gaps, rtol=0, atol=1e-4)


@pytest.mark.parametrize("lanes", [0, 4, 8, 16, 32])
def test_ell_matvec_at_every_row_length(cuda, lanes):
    """Rows of 0, 1, L-1, L, L+1 and K live entries, for each L the kernel
    has; every grid gives the same bits."""
    k_pad, d = 111, 1000
    lens = sorted({0, 1, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, k_pad})
    gen = torch.Generator().manual_seed(lanes)
    idx = torch.randint(0, d, (len(lens), k_pad), generator=gen, dtype=torch.int32)
    val = torch.randn(len(lens), k_pad, generator=gen)
    nnz = torch.tensor(lens, dtype=torch.int32)
    live = torch.arange(k_pad)[None, :] < nnz[:, None]
    idx, val = torch.where(live, idx, 0), torch.where(live, val, 0.0)
    pcsr = PaddedCSR(idx.cuda(), val.cuda(), nnz.cuda(), (len(lens), d))
    w = torch.randn(d, generator=gen).cuda()
    got = ell_matvec(pcsr, w, lanes=lanes)
    ref = ell_matvec_ref(pcsr.indices, pcsr.values, w)
    scale = ell_matvec_ref(pcsr.indices, pcsr.values.abs(), w.abs())
    assert bool(((got - ref).abs() <= 1e-5 * scale + 1e-7).all())
    assert float(got[0]) == 0.0
    for blocks in (0, 1, 2):
        assert torch.equal(got, ell_matvec(pcsr, w, lanes=lanes, blocks=blocks))
    with pytest.raises(ValueError, match="lanes"):
        ell_matvec(pcsr, w, lanes=2)


def test_rebuilding_draw_matches_plain(problem):
    """200 steps of (scatter, rebuilding draw): c within rtol/atol 1e-6 of the
    plain rebuild, each draw equal to the plain draw on the kernel's c, no
    group left touched, the arrival counter back at 0; a masked launch
    rebuilds and writes -1; the rebuild-only launch equals the plain one."""
    X, y, (pcsr, pcsc) = problem
    alpha = fw_setup(pcsr, torch.from_numpy(y.astype(np.float32)).cuda(), loss="logistic",
                     pcsc=pcsc)[2]
    state = tl_init(alpha.abs() * 200.0)
    plain = state.clone()
    counter = arrival_counter("cuda")
    _, keys = prng.key_chain(prng.PRNGKey(2), 200)
    rng = np.random.default_rng(0)
    for step, k in enumerate(keys):
        idx = torch.from_numpy(rng.integers(0, X.shape[1], 30)).cuda()
        vals = alpha.abs()[idx] * float(rng.uniform(50, 400))
        for st in (state, plain):
            tl_scatter_(st, idx, vals)
        got = two_level_draw(state.c, state.v, k, touched=state.touched)
        rebuild_groups_(plain.c, plain.v, plain.touched)
        torch.testing.assert_close(state.c, plain.c, rtol=1e-6, atol=1e-6)
        assert int(got) == int(two_level_draw_ref(state.c, state.v, k)), step
        assert int(state.touched.sum()) == 0 and int(counter) == 0, step
        plain.c.copy_(state.c)                     # the next step starts from the kernel's c
    tl_scatter_(state, idx, vals * 2)
    tl_scatter_(plain, idx, vals * 2)
    rebuild_groups_(plain.c, plain.v, plain.touched)
    out = two_level_draw(state.c, state.v, keys[0], touched=state.touched,
                         done=torch.tensor(True, device="cuda"))
    assert int(out) == -1 and int(state.touched.sum()) == 0 and int(counter) == 0
    torch.testing.assert_close(state.c, plain.c, rtol=1e-6, atol=1e-6)
    tl_scatter_(state, idx, vals * 3)
    tl_scatter_(plain, idx, vals * 3)
    before = two_level_draw.rebuilds
    tl_rebuild_(state)                                # the rebuild-only launch
    rebuild_groups_(plain.c, plain.v, plain.touched)
    assert two_level_draw.rebuilds == before + 1
    torch.testing.assert_close(state.c, plain.c, rtol=1e-6, atol=1e-6)
    assert int(state.touched.sum()) == 0 and int(counter) == 0


FLASH_CASES = [                          # b, s, h, kv, hd, causal, window
    (2, 128, 4, 2, 32, True, 0),
    (1, 256, 8, 8, 16, True, 0),
    (2, 128, 4, 1, 64, False, 0),
    (1, 256, 6, 2, 32, True, 64),
    (1, 200, 4, 2, 64, True, 0),         # a ragged last tile
    (2, 96, 4, 2, 128, True, 0),
    (1, 160, 2, 1, 256, True, 0),
    (1, 300, 4, 4, 64, True, 100),
    (3, 32, 8, 2, 64, True, 0),          # fewer rows than one tile (the probe's shape)
    (2, 50, 16, 2, 16, True, 0),         # hd 16, G = 8, fewer rows than one tile
    (1, 70, 8, 1, 32, False, 0),         # hd 32, G = 8, non-causal, ragged
    (2, 200, 8, 1, 64, False, 0),        # G = 8, non-causal, ragged
    (1, 130, 16, 2, 128, False, 0),      # hd 128, G = 8, non-causal, ragged
    (1, 20, 4, 1, 256, True, 0),         # hd 256, fewer rows than one tile
]


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, b, s, h, kv, hd, causal, window, dtype):
    gen = torch.Generator().manual_seed(s + hd)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda, dtype)
               for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    before = launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert launch_counts()["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 0.06
    for want in (attention_ref(q, k, v, causal=causal, window=window),
                 flash_attention_plain(q, k, v, causal=causal, window=window)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        if dtype == torch.bfloat16:
            # and within 4 bf16 spacings of max(|want|, the row's RMS over hd)
            ref = want.float()
            scale = torch.maximum(ref.abs(), ref.pow(2).mean(-1, keepdim=True).sqrt())
            diff = (got.float() - ref).abs()
            assert (diff <= 4 * torch.finfo(torch.bfloat16).eps * scale).all()
    assert torch.equal(got, flash_attention(q, k, v, causal=causal, window=window))


def _check_flash(got, want, dtype):
    tol = 2e-5 if dtype == torch.float32 else 0.06
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        scale = torch.maximum(want.abs(), want.pow(2).mean(-1, keepdim=True).sqrt())
        assert ((got.float() - want).abs() <= 4 * torch.finfo(torch.bfloat16).eps * scale).all()


@pytest.mark.parametrize("sq,sk,h,kv,hd", [(512, 1536, 16, 16, 64), (130, 300, 8, 2, 128),
                                          (64, 20, 4, 4, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_with_q_and_k_of_different_lengths(cuda, sq, sk, h, kv, hd, dtype):
    """Non-causal, S_q ≠ S_k (encdec's cross-attention): against the
    materialised oracle and the plain version (its k block divides S_k)."""
    gen = torch.Generator().manual_seed(sq + sk + hd)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda, dtype)
               for shape in ((2, sq, h, hd), (2, sk, kv, hd), (2, sk, kv, hd)))
    got = flash_attention(q, k, v, causal=False)
    assert got.shape == q.shape
    _check_flash(got, attention_ref(q, k, v, causal=False), dtype)
    block_k = 512 if sk % 512 == 0 else sk
    _check_flash(got, flash_attention_plain(q, k, v, causal=False, block_k=block_k), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_recurrentgemmas_local_shape(cuda, dtype):
    """Window 2,048 over S = 4,096 (the window masks), hd 256, MQA."""
    gen = torch.Generator().manual_seed(4096)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda, dtype)
               for shape in ((1, 4096, 10, 256), (1, 4096, 1, 256), (1, 4096, 1, 256)))
    got = flash_attention(q, k, v, causal=True, window=2048)
    _check_flash(got, flash_attention_plain(q, k, v, causal=True, window=2048), dtype)
    _check_flash(got, attention_ref(q, k, v, causal=True, window=2048), dtype)


@pytest.mark.parametrize("hd,hdv", [(18, 18), (24, 24), (112, 112), (192, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_pads_head_dims_outside_the_table(cuda, hd, hdv, dtype):
    gen = torch.Generator().manual_seed(hd + hdv)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda, dtype)
               for shape in ((2, 130, 8, hd), (2, 130, 2, hd), (2, 130, 2, hdv)))
    got = flash_attention(q, k, v)
    assert got.shape == (2, 130, 8, hdv) and got.dtype == dtype
    want = flash_attention_plain(q, k, v).float()
    tol = 2e-5 if dtype == torch.float32 else 0.06
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        scale = torch.maximum(want.abs(), want.pow(2).mean(-1, keepdim=True).sqrt())
        assert ((got.float() - want).abs() <= 4 * torch.finfo(torch.bfloat16).eps * scale).all()


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "bf16_tensor_cores"),
                                         (torch.float32, "f32_cuda_cores")])
def test_flash_attention_routes_by_dtype(cuda, dtype, route):
    q = torch.randn(1, 128, 4, 64, device=cuda).to(dtype)
    k = torch.randn(1, 128, 2, 64, device=cuda).to(dtype)
    reset_launch_counts()
    flash_attention(q, k, k)
    assert launch_counts()["flash_attention"] == 1
    assert flash_attention.routes == {name: int(name == route)
                                      for name in ("bf16_tensor_cores", "f32_cuda_cores")}


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 64, 4, 320, device=cuda)       # past the widest head dim (256)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros(1, 64, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention(q, q[:, :, :2].contiguous().half(), q[:, :, :2].contiguous().half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), q[:, :, :2].contiguous(),
                        q[:, :, :2].contiguous())


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _recorded_routes(monkeypatch) -> list:
    """Each MoE layer's expert ids, per token as a sorted set, in call order."""
    calls, route = [], model_common.moe_route

    def record(p, x, cfg):
        out = route(p, x, cfg)
        calls.append(out[2].sort(dim=-1).values.cpu())
        return out

    monkeypatch.setattr(model_common, "moe_route", record)
    return calls


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "llama3.2-1b", "minicpm-2b",
                                  "nemotron-4-15b", "chameleon-34b", "deepseek-v2-236b",
                                  "kimi-k2-1t-a32b"])
def test_card_forward_and_decode_match_cpu(cuda, arch, monkeypatch):
    cpu_api = get_model(arch, smoke=True, device="cpu")
    api = get_model(arch, smoke=True, device="cuda")
    params_cpu = cpu_api.init(0)
    params = _to(params_cpu, cuda)
    toks = torch.randint(1, 200, (2, 64), generator=torch.Generator().manual_seed(1))
    routes = _recorded_routes(monkeypatch)
    reset_launch_counts()
    got = api.forward(params, toks.to(cuda))
    assert launch_counts()["flash_attention"] == api.cfg.n_layers
    card_routes, routes[:] = list(routes), []
    want = cpu_api.forward(params_cpu, toks)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    moe_layers = api.cfg.n_layers - api.cfg.first_dense_layers if api.cfg.n_experts else 0
    assert len(card_routes) == len(routes) == moe_layers
    assert all(torch.equal(a, b) for a, b in zip(card_routes, routes))
    cache = api.init_cache(2, 80)
    for t in range(64):
        logits, cache = api.decode_step(params, cache, toks[:, t:t + 1].to(cuda), t)
    assert float((logits[:, 0] - got[:, -1]).abs().max()) < 5e-4


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_card_moe_batched_decode_with_row_positions_equals_row_decodes(cuda, arch):
    api = get_model(arch, smoke=True, device="cuda")
    params = api.init(0)
    toks = torch.randint(1, 200, (3, 12), generator=torch.Generator().manual_seed(4)).to(cuda)
    starts = [0, 3, 7]
    cache = api.init_cache(3, 16)
    rows = []
    for b, n in enumerate(starts):
        row_cache = {g: {k: v[:, b:b + 1] for k, v in bufs.items()} for g, bufs in cache.items()}
        for t in range(n):
            api.decode_step(params, row_cache, toks[b:b + 1, t:t + 1], t)
        single = {g: {k: v.clone() for k, v in bufs.items()} for g, bufs in row_cache.items()}
        rows.append(api.decode_step(params, single, toks[b:b + 1, n:n + 1], n)[0])
    pos = torch.tensor(starts, device=cuda)
    got, _ = api.decode_step(params, cache, toks[torch.arange(3, device=cuda), pos][:, None],
                             pos)
    torch.testing.assert_close(got, torch.cat(rows), rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch,overrides,flash", [
    ("falcon-mamba-7b", None, 0), ("recurrentgemma-2b", None, 1),
    ("seamless-m4t-medium", None, 6), ("tinyllama-1.1b", {"window": 8}, 2)])
def test_card_other_families_match_cpu_and_decode_past_the_window(cuda, arch, overrides,
                                                                  flash):
    """The forward on the card against the CPU's (``flash``: the forward's
    launches), and decode ≡ forward over 40 tokens: past rglru's window of
    32 and the dense ring's 8 (their rings wrap); encdec after
    ``prefill_cross`` on 24 frames."""
    from repro_torch.models import encdec
    cpu_api = get_model(arch, smoke=True, device="cpu", overrides=overrides)
    api = get_model(arch, smoke=True, device="cuda", overrides=overrides)
    params_cpu = cpu_api.init(0)
    params = _to(params_cpu, cuda)
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(1, 200, (2, 40), generator=gen)
    frames = torch.randn(2, 24, api.cfg.d_model, generator=gen)
    batch = (lambda d: {"frames": frames.to(d), "tokens": toks.to(d)}) \
        if api.cfg.family == "encdec" else toks.to
    reset_launch_counts()
    got = api.forward(params, batch(cuda))
    assert launch_counts()["flash_attention"] == flash
    torch.testing.assert_close(got.cpu(), cpu_api.forward(params_cpu, batch("cpu")), rtol=0,
                               atol=1e-4)
    cache = api.init_cache(2, 64)
    if api.cfg.family == "encdec":
        encdec.prefill_cross(params, cache, frames.to(cuda), api.cfg)
    for t in range(40):
        logits, cache = api.decode_step(params, cache, toks[:, t:t + 1].to(cuda), t)
        assert float((logits[:, 0] - got[:, t]).abs().max()) < 5e-4, t


def test_card_engine_matches_cpu_engine(cuda):
    cpu_api = get_model("tinyllama-1.1b", smoke=True, device="cpu")
    api = get_model("tinyllama-1.1b", smoke=True, device="cuda")
    params_cpu = cpu_api.init(0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 100, int(rng.integers(3, 9))).astype(np.int32)
               for _ in range(5)]
    out = []
    for a, p in ((cpu_api, params_cpu), (api, _to(params_cpu, cuda))):
        engine = ServingEngine(a, p, ServeConfig(slots=2, max_len=64))
        for i, prompt in enumerate(prompts):
            engine.submit(Request(uid=i, prompt=prompt, max_new_tokens=6))
        out.append({r.uid: r.generated for r in engine.run()})
    assert out[0] == out[1]


def _cache_counts(tel) -> dict:
    return {f"{m['labels']['cache']}_{m['labels']['outcome']}": m["value"]
            for m in tel.metrics.snapshot() if m["name"] == "store.cache"}


@pytest.mark.parametrize("queue", ["two_level", "group_argmax"])
def test_card_store_solve_matches_in_memory_solve(cuda, tmp_path, queue):
    """``solve(store)`` on the card equals ``solve(X, y)`` on the card bit
    for bit, cold (caches written) and warm (replayed: no setup launch)."""
    from repro_torch import obs
    from repro_torch.data.store import DatasetStore
    X, y, _ = make_sparse_classification(n=600, d=2000, nnz_per_row=12, informative=20, seed=5)
    root = str(tmp_path / "store")
    DatasetStore.from_arrays(root, X, y, rows_per_shard=128)
    cfg = FWConfig(backend="torch_sparse", lam=20.0, steps=60, queue=queue, epsilon=1.0,
                   delta=1e-6)
    ref = solve(X, y, cfg)
    for phase, want in (("cold", {"padded_miss": 1, "setup_miss": 1, "autotune_miss": 1}),
                        ("warm", {"padded_hit": 1, "setup_hit": 1, "autotune_miss": 1})):
        reset_launch_counts()
        with obs.session() as tel:
            got = solve(DatasetStore.open(root), config=cfg)
        assert _cache_counts(tel) == want, phase
        assert launch_counts()["ell_rmatvec"] == (2 if phase == "cold" else 0), phase
        assert launch_counts()["coord_update"] == 60, phase
        for k in ("coords", "w", "gaps"):
            assert torch.equal(getattr(got, k), getattr(ref, k)), f"{phase}: {k}"


def test_card_setup_cache_is_the_cuda_file_and_never_read_on_the_cpu(cuda, tmp_path):
    import os

    from repro_torch import obs
    from repro_torch.data.store import DatasetStore
    X, y, _ = make_sparse_classification(n=300, d=900, nnz_per_row=10, informative=15, seed=6)
    root = str(tmp_path / "store")
    DatasetStore.from_arrays(root, X, y, rows_per_shard=100)
    cfg = FWConfig(backend="torch_sparse", lam=10.0, steps=30, queue="two_level")
    solve(DatasetStore.open(root), config=cfg)
    cache = os.path.join(root, "cache")
    setup_files = sorted(f for f in os.listdir(cache) if f.startswith("setup-"))
    assert setup_files == ["setup-logistic-torch-cuda.npz"]
    with open(os.path.join(cache, setup_files[0]), "rb") as f:
        card_bytes = f.read()
    cpu_cfg = dataclasses.replace(cfg, device="cpu")
    with obs.session() as tel:
        got = solve(DatasetStore.open(root), config=cpu_cfg)
    assert _cache_counts(tel) == {"padded_hit": 1, "setup_miss": 1, "autotune_miss": 1}
    ref = solve(X, y, cpu_cfg)
    for k in ("coords", "w", "gaps"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    assert sorted(f for f in os.listdir(cache) if f.startswith("setup-")) == [
        "setup-logistic-torch-cpu.npz", "setup-logistic-torch-cuda.npz"]
    with open(os.path.join(cache, setup_files[0]), "rb") as f:
        assert f.read() == card_bytes


# ---- the lane kernels (solve_many's lane form) ---------------------------------


def _lane_state(alpha, lanes, private, em, d):
    """B lanes of distinct state: lane b's w, w_m, g̃ and α scaled by its own
    factors, and its queue from its own α."""
    gen = torch.Generator().manual_seed(lanes)
    w = (torch.randn(lanes, d, generator=gen) * (torch.rand(lanes, d, generator=gen) < 0.2))
    scale = torch.tensor([1.0 + 0.25 * b for b in range(lanes)])
    a = (alpha[None, :].cpu() * scale[:, None]).cuda()
    prio = a.abs() * torch.tensor(em, device="cuda")[:, None]
    return dict(w=w.cuda(), w_m=torch.tensor([0.8 - 0.05 * b for b in range(lanes)]).cuda(),
                g_tilde=torch.tensor([0.5 + 0.1 * b for b in range(lanes)]).cuda(),
                alpha=a, queue=tl_init(prio) if private else ga_init(prio))


@pytest.mark.parametrize("layout", ["flat", "tiered"])
@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("lanes", [1, 3, 8])
def test_lane_coord_update_equals_single_kernel_per_lane(long_problem, lanes, private,
                                                         layout):
    """Three steps of B lanes, each lane on its own column (short and long
    routes in one launch), the last lane of a group done: every lane's state
    and outputs equal the single-config kernel's on that lane bit for bit,
    and the first step meets the bitwise rule against the plain version."""
    X, y, (pcsr, flat) = long_problem
    n, d = X.shape
    pcsc = flat if layout == "flat" else tiered_from_padded(flat, 8)
    y_t = torch.from_numpy(y.astype(np.float32)).cuda()
    vbar, qbar, alpha = fw_setup(pcsr, y_t, loss="logistic", pcsc=flat)
    nnz = flat.nnz.cpu()
    short = torch.nonzero((nnz >= 1) & (nnz <= short_route_max_rows())).flatten()[:4].tolist()
    heavy = [int(torch.argmax(nnz))] + torch.nonzero(nnz > 300).flatten()[:3].tolist()
    cols = [c for pair in zip(short, heavy) for c in pair]
    em = [30.0 + 10.0 * b if private else 1.0 for b in range(lanes)]
    lams = [8.0 + b for b in range(lanes)]
    st = _lane_state(alpha, lanes, private, em, d)
    st.update(vbar=vbar[None].expand(lanes, -1).clone(), qbar=qbar[None].expand(lanes, -1).clone())
    singles = [{k: (v.lane(b).clone() if k == "queue" else v[b].clone()) for k, v in st.items()}
               for b in range(lanes)]
    done = torch.zeros(lanes, dtype=torch.bool, device="cuda")
    done[lanes - 1] = lanes > 1
    stop_at = torch.zeros(lanes, dtype=torch.int32, device="cuda")
    s_done = [done[b:b + 1].clone() for b in range(lanes)]
    s_stop = [stop_at[b:b + 1].clone() for b in range(lanes)]
    gaps = torch.zeros((lanes, 4), device="cuda")
    coords = torch.zeros((lanes, 4), dtype=torch.int32, device="cuda")
    s_out = [(torch.zeros(4, device="cuda"), torch.zeros(4, dtype=torch.int32, device="cuda"))
             for _ in range(lanes)]
    scratch = coord_update_scratch(n, d, "cuda", lanes=lanes)
    one = coord_update_scratch(n, d, "cuda")
    scalars = lane_scalars(lams, em, [0.0] * lanes, "cuda")
    cpu_csr, cpu_csc, y_cpu = pcsr.to("cpu"), pcsc.to("cpu"), y_t.cpu()
    for step in range(3):
        js = [cols[(b + step) % len(cols)] for b in range(lanes)]
        before = [{k: (v.lane(b).to("cpu") if k == "queue" else v[b].cpu())
                   for k, v in st.items()} for b in range(lanes)]
        reset_launch_counts()
        coord_update_lanes(torch.tensor(js, dtype=torch.int32, device="cuda"), pcsr, pcsc, y_t,
                           st["w"], st["w_m"], st["g_tilde"], st["vbar"], st["qbar"],
                           st["alpha"], st["queue"], t=float(step + 2), scalars=scalars,
                           inv_n=1.0 / n, loss="logistic", gaps=gaps, coords=coords,
                           slot=step, scratch=scratch, done=done, stop_at=stop_at)
        assert launch_counts()["coord_update_lanes"] == 1
        gs = scratch.gs.clone()
        for b in range(lanes):
            sb = singles[b]
            coord_update(torch.tensor([js[b]], dtype=torch.int32, device="cuda"), pcsr, pcsc,
                         y_t, sb["w"], sb["w_m"], sb["g_tilde"], sb["vbar"], sb["qbar"],
                         sb["alpha"], sb["queue"], t=float(step + 2), lam=lams[b],
                         inv_n=1.0 / n, em_scale=em[b], loss="logistic", gaps=s_out[b][0],
                         coords=s_out[b][1], slot=step, scratch=one, done=s_done[b],
                         stop_at=s_stop[b])
            lane = {k: (v.lane(b) if k == "queue" else v[b]) for k, v in st.items()}
            lane.update(gaps=gaps[b], coords=coords[b])
            sb_all = dict(sb, gaps=s_out[b][0], coords=s_out[b][1])
            assert _same_bits(_bits(lane), _bits(sb_all)), (lanes, step, b, js[b])
            if bool(done[b]):
                assert int(coords[b, step]) == -1 and float(gaps[b, step]) == 0.0
            elif step == 0:
                k = int(flat.nnz[js[b]])
                after = {key: v.cpu() for key, v in lane.items()
                         if key not in ("gaps", "coords", "queue")}
                after.update(queue=lane["queue"].to("cpu"), gaps=gaps[b, :1].cpu(),
                             coords=coords[b, :1].cpu())
                bad = bitwise_rule_mismatches(js[b], cpu_csr, cpu_csc, y_cpu, before[b], after,
                                              gs[b, :k].cpu(), t=2.0, lam=lams[b],
                                              inv_n=1.0 / n, em_scale=em[b], loss="logistic")
                assert bad == [], (b, js[b], bad)
        if private:      # the next draw's rebuild, on both sides
            tl_rebuild_(st["queue"])
            for sb in singles:
                tl_rebuild_(sb["queue"])
    live = lanes - 1 if lanes > 1 else 1
    routes = scratch.routes[:live].sum(0).tolist()
    assert routes[0] > 0 and routes[1] > 0, routes   # both routes in the lane launches


@pytest.mark.parametrize("lanes", [1, 3, 8])
def test_lane_draw_equals_single_draw_and_plain(problem, lanes):
    """60 steps of B lanes' scatters and rebuilding draws, one launch a step:
    each lane's draw and c equal the single-config kernel's on that lane,
    the draw equals the plain draw on the kernel's c, a done lane writes -1,
    and every lane's arrival counter is 0 after each launch."""
    X, y, (pcsr, pcsc) = problem
    alpha = fw_setup(pcsr, torch.from_numpy(y.astype(np.float32)).cuda(), loss="logistic",
                     pcsc=pcsc)[2]
    em = torch.tensor([200.0 + 50.0 * b for b in range(lanes)], device="cuda")
    state = tl_init(alpha.abs()[None, :] * em[:, None])
    singles = [state.lane(b).clone() for b in range(lanes)]
    chains = [prng.key_chain(prng.PRNGKey(b + 5), 60)[1] for b in range(lanes)]
    table = key_table(chains, "cuda")
    done = torch.zeros(lanes, dtype=torch.bool, device="cuda")
    done[lanes // 2] = lanes > 1
    out = torch.empty(lanes, dtype=torch.int32, device="cuda")
    rng = np.random.default_rng(lanes)
    reset_launch_counts()
    for step in range(60):
        for b in range(lanes):
            idx = torch.from_numpy(rng.integers(0, X.shape[1], 30)).cuda()
            vals = alpha.abs()[idx] * float(rng.uniform(50, 400))
            tl_scatter_(state.lane(b), idx, vals)
            tl_scatter_(singles[b], idx, vals)
        two_level_draw_lanes(state.c, state.v, table[step], out, done=done,
                             touched=state.touched)
        assert int(arrival_counter("cuda", lanes).abs().sum()) == 0, step
        for b in range(lanes):
            one = two_level_draw(singles[b].c, singles[b].v, chains[b][step],
                                 done=done[b:b + 1], touched=singles[b].touched)
            assert int(one) == int(out[b]), (step, b)
            assert same_bits(singles[b].c, state.c[b]), (step, b)
            want = -1 if bool(done[b]) else int(two_level_draw_ref(state.c[b], state.v[b],
                                                                   chains[b][step]))
            assert int(out[b]) == want, (step, b)
        assert int(state.touched.sum()) == 0
    assert launch_counts()["two_level_draw_lanes"] == 60
    tl_scatter_(state.lane(0), idx, vals * 2)       # the rebuild-only launch, every lane
    plain = state.clone()
    tl_rebuild_(state)
    for b in range(lanes):
        rebuild_groups_(plain.c[b], plain.v[b], plain.touched[b])
    torch.testing.assert_close(state.c, plain.c, rtol=1e-6, atol=1e-6)
    assert int(state.touched.sum()) == 0


@pytest.mark.parametrize("private", [False, True])
def test_card_sweep_equals_per_config_solves(problem, private):
    """``solve_many`` on the card, lanes and sequential, equals each config's
    own ``solve`` bit for bit; the lane sweep launches each kernel once a step
    for the whole group and ``ell_rmatvec`` once per group; a gap_tol cohort
    retires each config at its own step."""
    X, y, pair = problem
    configs = grid(FWConfig(backend="torch_sparse", steps=40, delta=1e-6,
                            queue="two_level" if private else None),
                   lam=(4.0, 8.0, 16.0, 32.0), epsilon=(0.5, 2.0))
    want = [solve(pair, y, c) for c in configs]
    reset_launch_counts()
    lanes = solve_many(pair, y, configs, plan="vmap")
    counts = launch_counts()
    assert counts["coord_update_lanes"] == 40 and counts["coord_update"] == 0
    assert counts["two_level_draw_lanes"] == (40 if private else 0)
    assert counts["ell_rmatvec"] == 2
    seq = solve_many(pair, y, configs, plan="sequential")
    for got_l, got_s, ref in zip(lanes, seq, want):
        for name in ("w", "gaps", "coords"):
            assert torch.equal(getattr(got_l, name), getattr(ref, name)), name
            assert torch.equal(getattr(got_s, name), getattr(ref, name)), name
    tols = [float(ref.gaps[10 + 7 * i].abs()) + 1e-9 for i, ref in enumerate(want[:4])]
    cohort = [dataclasses.replace(c, gap_tol=t, chunk_steps=8) for c, t in zip(configs, tols)]
    got = solve_many(pair, y, cohort, plan="vmap")
    for c, res in zip(cohort, got):
        ref = solve(pair, y, c)
        assert res.stop_step_or() == ref.stop_step_or() and res.stop_reason == ref.stop_reason
        assert torch.equal(res.w, ref.w) and torch.equal(res.coords, ref.coords)


# ---------------------------------------------------------------------------
# screening and λ-paths on the card
# ---------------------------------------------------------------------------

SCREENED = {"alg2_private": dict(backend="torch_sparse", queue="two_level", epsilon=4.0),
            "alg2_nonprivate": dict(backend="torch_sparse", queue="group_argmax"),
            "alg1_argmax": dict(backend="dense", selection="argmax")}


def _recording_commits(monkeypatch) -> list:
    """Each fired round's survivors (original ids), as ``Screener.commit``
    folds them in."""
    from repro_torch.core.solvers import screening
    sets, real = [], screening.Screener.commit

    def commit(self, keep, **kw):
        out = real(self, keep, **kw)
        sets.append(self.sel.copy())
        return out

    monkeypatch.setattr(screening.Screener, "commit", commit)
    return sets


@pytest.mark.parametrize("run", list(SCREENED))
def test_card_screened_solve_matches_cpu(problem, monkeypatch, run):
    """A screened solve on the card takes the CPU's coordinates and keeps the
    CPU's survivor sets round by round; w and the gaps within 1e-4; the
    repack runs on the card (the swapped-in pair lives there)."""
    from repro_torch.core.solvers import screening
    X, y, pair = problem
    cfg = FWConfig(lam=8.0, steps=60, chunk_steps=12, screen_every=1, seed=2,
                   **SCREENED[run])
    sets = _recording_commits(monkeypatch)
    placed = []
    real_repack = screening.repack_pair
    monkeypatch.setattr(screening, "repack_pair", lambda *a: placed.append(
        a[0].device.type) or real_repack(*a))
    card = solve(pair, y, cfg)
    card_sets = [s.copy() for s in sets]
    sets.clear()
    cpu = solve(tuple(t.to("cpu") for t in pair), y, dataclasses.replace(cfg, device="cpu"))
    assert card_sets and len(card_sets) == len(sets)
    for a, b in zip(card_sets, sets):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(card.coords.cpu(), cpu.coords)
    torch.testing.assert_close(card.w.cpu(), cpu.w, rtol=0, atol=1e-4)
    torch.testing.assert_close(card.gaps.cpu(), cpu.gaps, rtol=0, atol=1e-4)
    assert card.w.shape == (X.shape[1],) and card.w.device.type == "cuda"
    assert set(placed) == {"cuda", "cpu"}   # the card's run repacked on the card


@pytest.mark.parametrize("run", list(SCREENED))
def test_card_keep_all_round_keeps_the_bits(problem, monkeypatch, run):
    from repro_torch.core.solvers import screening
    X, y, pair = problem
    monkeypatch.setattr(screening.Screener, "screen",
                        lambda self, scores, support: np.ones(scores.shape[0], bool))
    cfg = FWConfig(lam=8.0, steps=60, chunk_steps=12, screen_every=1, seed=2,
                   **SCREENED[run])
    got = solve(pair, y, cfg)
    eps = screening.solve_epsilon(cfg) if run == "alg2_private" else cfg.epsilon
    ref = solve(pair, y, dataclasses.replace(cfg, screen_every=0, epsilon=eps))
    for name in ("coords", "w", "gaps"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


@pytest.mark.parametrize("layout", ["flat", "tiered"])
@pytest.mark.parametrize("private", [False, True])
def test_coord_update_bitwise_rule_on_a_repacked_pair(long_problem, private, layout):
    """After a repack (the survivors' pair, its own owner table and segment
    order), the card's step meets the bitwise rule against the CPU on the
    heaviest and a light surviving column, on both routes."""
    from repro_torch.core.solvers.screening import repack_pair
    X, y, (pcsr0, flat0) = long_problem
    n, d0 = X.shape
    col_nnz0 = flat0.nnz.cpu().numpy()
    keep = np.random.default_rng(4).random(d0) < 0.3
    keep[int(np.argmax(col_nnz0))] = True
    pcsc0 = flat0 if layout == "flat" else tiered_from_padded(flat0, 8)
    pcsr, pcsc = repack_pair(pcsr0, pcsc0, keep)
    assert pcsc.device.type == "cuda" and pcsr.shape == (n, int(keep.sum()))
    assert cu_ops.owner_table(pcsc) is not cu_ops.owner_table(pcsc0)
    d = pcsr.shape[1]
    y_t = torch.from_numpy(y.astype(np.float32)).cuda()
    vbar, qbar, alpha = fw_setup(pcsr, y_t, loss="logistic", pcsc=pcsc)
    em = 30.0 if private else 1.0
    base = dict(w=torch.zeros(d, device="cuda"), w_m=torch.tensor(0.8, device="cuda"),
                g_tilde=torch.tensor(0.5, device="cuda"), vbar=vbar, qbar=qbar, alpha=alpha,
                queue=tl_init(alpha.abs() * em) if private else ga_init(alpha.abs()))
    before = {k: v.to("cpu") for k, v in base.items()}
    step = dict(t=4.0, lam=8.0, inv_n=1.0 / n, em_scale=em, loss="logistic")
    cpu_csr, cpu_csc = pcsr.to("cpu"), pcsc.to("cpu")
    col_nnz = pcsc.nnz.cpu().numpy()
    live = np.flatnonzero(col_nnz > 0)
    scratch = coord_update_scratch(n, d, "cuda")
    for j in (int(np.argmax(col_nnz)), int(live[np.argmin(col_nnz[live])])):
        card = _card_step(j, pcsr, pcsc, y_t, base, step, scratch, "auto")
        after = {key: v.to("cpu") for key, v in card.items()}
        bad = bitwise_rule_mismatches(j, cpu_csr, cpu_csc, y_t.cpu(), before, after,
                                      scratch.gs[:int(col_nnz[j])].cpu(), **step)
        assert bad == [], (j, bad)
        for route in ("short", "long"):
            again = _card_step(j, pcsr, pcsc, y_t, base, step, scratch, route)
            assert _same_bits(_bits(card), _bits(again)), (j, route)


@pytest.mark.parametrize("queue", ["two_level", "group_argmax"])
def test_card_path_group_lanes_equal_sequential(problem, queue):
    """A λ-path group as lanes on the card equals the per-config path drivers
    bit for bit, segment by segment, with one lane launch of each kernel a
    step for the whole group and one setup."""
    from repro_torch.core.solvers import solve_path
    X, y, pair = problem
    lambdas = (16.0, 8.0, 4.0)
    cfgs = [FWConfig(backend="torch_sparse", steps=40, chunk_steps=10, queue=queue,
                     lam=lambdas[0], lambdas=lambdas, epsilon=eps, seed=seed)
            for eps, seed in ((0.5, 0), (1.0, 1), (2.0, 2))]
    reset_launch_counts()
    lanes = solve_many(pair, y, cfgs, plan="vmap")
    counts = launch_counts()
    total = sum(lanes[0].plan.budgets)
    assert counts["coord_update_lanes"] == total and counts["coord_update"] == 0
    assert counts["two_level_draw_lanes"] == (total if queue == "two_level" else 0)
    assert counts["ell_rmatvec"] == 2
    seq = solve_many(pair, y, cfgs, plan="sequential")
    for c, a, b in zip(cfgs, lanes, seq):
        own = solve_path(pair, y, config=c)
        for k in range(len(lambdas)):
            for name in ("w", "gaps", "coords"):
                assert torch.equal(getattr(a[k], name), getattr(b[k], name)), (k, name)
                assert torch.equal(getattr(a[k], name), getattr(own[k], name)), (k, name)
            assert a[k].stop_step_or() == b[k].stop_step_or()
    cpu = solve_path(X, y, config=dataclasses.replace(cfgs[0], device="cpu"))
    for k in range(len(lambdas)):
        assert torch.equal(lanes[0][k].coords.cpu(), cpu[k].coords)
        torch.testing.assert_close(lanes[0][k].w.cpu(), cpu[k].w, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the other engines and the fit service on the card


@pytest.mark.parametrize("tile", ["full", "live"])
@pytest.mark.parametrize("private", [False, True])
@pytest.mark.parametrize("loss", LOSSES)
def test_card_torch_dense_matches_cpu_and_torch_sparse(problem, loss, private, tile):
    from repro_torch.core.fw_torch import sparse_fw_torch
    X, y, (pcsr, pcsc) = problem
    cfg = FWConfig(backend="torch_dense", lam=8.0, steps=60, loss=loss, device="cuda",
                   queue="two_level" if private else "group_argmax")
    y_t = torch.from_numpy(y.astype(np.float32))
    reset_launch_counts()
    card = sparse_fw_torch(pcsr, pcsc, y_t.cuda(), cfg, tile=tile)
    counts = launch_counts()
    assert counts["ell_rmatvec"] == (2 if loss in ("logistic", "squared") else 1)
    assert two_level_draw.rebuilds == (60 if private else 0)
    assert 0 < counts["scatter_add_ordered"] <= 3 * 60       # v̄, q̄ and α a step, in order
    assert sum(counts.values()) == counts["ell_rmatvec"] + counts["scatter_add_ordered"]
    again = sparse_fw_torch(pcsr, pcsc, y_t.cuda(), cfg, tile=tile)
    for name in ("w", "gaps", "coords"):                        # the fixed scatter order
        assert torch.equal(getattr(card, name), getattr(again, name)), name
    cpu = sparse_fw_torch(*host_to_padded(X, device="cpu"), y_t,
                          dataclasses.replace(cfg, device="cpu"), tile=tile)
    sparse = solve((pcsr, pcsc), y, dataclasses.replace(cfg, backend="torch_sparse"))
    for ref in (cpu, sparse):
        assert torch.equal(card.coords.cpu(), ref.coords.cpu())
        assert float((card.w.cpu() - ref.w.cpu()).abs().max()) <= 1e-4
        assert float((card.gaps.cpu() - ref.gaps.cpu()).abs().max()) <= 1e-4
    assert torch.equal(card.w.cpu(), cpu.w)                 # the CPU's scatter order


def test_card_scatter_order_is_fixed(cuda):
    from repro_torch.core.fw_torch import scatter_add
    g = np.random.default_rng(0)
    idx = torch.from_numpy(g.integers(0, 40, size=4000)).cuda()
    src = torch.from_numpy(g.normal(size=4000).astype(np.float32)).cuda()
    live = torch.from_numpy(g.random(4000) < 0.8).cuda()
    dst = torch.from_numpy(g.normal(size=40).astype(np.float32)).cuda()
    first = scatter_add(dst, idx, src, live)
    for _ in range(5):
        assert torch.equal(first, scatter_add(dst, idx, src, live))
    plain = scatter_add(dst.cpu(), idx.cpu(), src.cpu(), live.cpu())    # input order
    assert torch.equal(first.cpu(), plain)                              # the kernel's order too


@pytest.mark.parametrize("private", [False, True])
def test_card_reference_fw_matches_torch_sparse(problem, private):
    from repro_torch.core.solvers.reference import reference_fw
    from repro_torch.core.solvers.torch_sparse import em_scale_for
    X, y, (pcsr, pcsc) = problem
    cfg = FWConfig(backend="torch_sparse", lam=8.0, steps=60, device="cuda",
                   queue="two_level" if private else "group_argmax")
    reset_launch_counts()
    w, gaps, coords = reference_fw(pcsr, pcsc, torch.from_numpy(y.astype(np.float32)).cuda(),
                                   lam=8.0, steps=60, private=private,
                                   em_scale=em_scale_for(cfg, X.shape[0]))
    counts = launch_counts()     # the oracle's only kernel is the in-order scatter
    assert counts["scatter_add_ordered"] > 0 and two_level_draw.rebuilds == 0
    assert sum(counts.values()) == counts["scatter_add_ordered"]
    ref = solve((pcsr, pcsc), y, cfg)
    assert torch.equal(coords, ref.coords)
    assert float((w - ref.w).abs().max()) <= 1e-4 and float((gaps - ref.gaps).abs().max()) <= 1e-4


def test_card_host_sparse_returns_card_tensors(problem):
    X, y, _ = problem
    card = solve(X, y, FWConfig(backend="host_sparse", lam=8.0, steps=30))
    cpu = solve(X, y, FWConfig(backend="host_sparse", lam=8.0, steps=30, device="cpu"))
    assert card.w.device.type == "cuda" and card.coords.dtype == torch.int32
    for name in ("w", "gaps", "coords"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name))


def test_card_fit_service_answers_equal_own_solves(problem):
    from repro_torch.core.dp.accountant import PrivacyAccountant
    from repro_torch.serve import FitRequest, FitService, FitServiceConfig
    X, y, pair = problem
    svc = FitService(pair, y, {"acme": PrivacyAccountant(epsilon=8.0, delta=1e-6,
                                                         total_steps=400)},
                     FitServiceConfig(slots=4))
    reqs = list(grid(FWConfig(backend="torch_sparse", steps=40, queue="two_level"),
                     lam=(4.0, 8.0), epsilon=(0.5, 1.0)))
    reqs += [FWConfig(backend="jax_dense", lam=8.0, steps=40),
             FWConfig(backend="dense", lam=8.0, steps=40),
             FWConfig(backend="host_sparse", lam=8.0, steps=40),
             FWConfig(backend="torch_dense", steps=40, max_seconds=1.0)]
    for uid, cfg in enumerate(reqs):
        svc.submit(FitRequest(uid=uid, tenant="acme", config=cfg))
    reset_launch_counts()
    done = svc.run()
    assert [r.status for r in done] == ["done"] * 7 + ["rejected"]
    assert launch_counts()["two_level_draw_lanes"] in (0, 40)
    for r in done[:7]:
        ref = solve(pair, y, r.config)
        for name in ("w", "gaps", "coords"):
            assert torch.equal(getattr(r.result, name).cpu(), getattr(ref, name).cpu()), r.uid
    assert all(rec["exact"] for rec in svc.verify_ledger().values())
    assert svc.accountants["acme"].spent_steps == sum(
        FitService._charged_steps(PrivacyAccountant(epsilon=8.0, delta=1e-6, total_steps=400),
                                  r.config) for r in done[:4])


# the sharded engine on the card (a 1×1 grid, no process group)


@pytest.mark.parametrize("queue", ["argmax", "bsls"])
def test_card_jax_shard_matches_cpu(problem, queue):
    X, y, _ = problem
    cfg = FWConfig(backend="jax_shard", lam=8.0, steps=60, queue=queue)
    reset_launch_counts()
    card = solve(X, y, cfg)
    counts = launch_counts()
    assert counts["scatter_add_ordered"] >= 3 * 60        # v̄, q̄ and α a step, and the setup
    assert sum(counts.values()) == counts["scatter_add_ordered"]
    cpu = solve(X, y, dataclasses.replace(cfg, device="cpu"))
    assert card.w.device.type == "cuda"
    assert torch.equal(card.coords.cpu(), cpu.coords)
    assert torch.equal(card.w.cpu(), cpu.w)
    assert float((card.gaps.cpu() - cpu.gaps).abs().max()) <= 1e-4


@pytest.mark.parametrize("selection", ["argmax", "gumbel"])
def test_card_compress_topk_matches_cpu(problem, selection):
    """The error-feedback top-k α exchange (``compress_topk``), which only
    ``distributed_fw`` reaches, on the card (its default device) against
    the same 1×1 run on the CPU."""
    from repro_torch.distributed import DistFWConfig, build_block_sparse, distributed_fw
    X, y, _ = problem
    blocks = build_block_sparse(X, 1, 1)
    y_pad = np.zeros(blocks.padded[0], np.float32)
    y_pad[:len(y)] = y
    cfg = DistFWConfig(lam=8.0, steps=60, selection=selection, compress_topk=8, seed=2)
    reset_launch_counts()
    w, gaps, coords, stop = distributed_fw(blocks, y_pad, cfg)
    counts = launch_counts()
    assert w.device.type == "cuda" and int(stop) == 60
    # the setup, then v̄, q̄, the α delta and the gathered top-k a step
    assert counts["scatter_add_ordered"] == 1 + 4 * 60
    assert sum(counts.values()) == counts["scatter_add_ordered"]
    cw, cgaps, ccoords, _ = distributed_fw(blocks, y_pad, cfg, device="cpu")
    assert torch.equal(coords.cpu(), ccoords)
    assert float((w.cpu() - cw).abs().max()) <= 1e-4
    assert float((gaps.cpu() - cgaps).abs().max()) <= 1e-4


# ---- training: the attention backward kernel, the training step ------------

# the backward kernel against its plain version (models/flash.py _flash_bwd on
# the card, the same inputs): float32 max |d| <= 2e-5 max |plain| (both sum in
# float32, in other orders); bf16 the forward's two forms, 0.06 (absolute and
# relative) and 4 bf16 spacings of max(|plain|, the row's RMS over hd, the
# tensor's RMS): a row whose terms cancel (a causal first query's dq) is ~0 in
# both, apart by float32 rounding of terms of the tensor's size
BWD_CASES = [
    (2, 256, 256, 8, 2, 64, 64, True, 0),        # causal GQA
    (1, 200, 200, 4, 4, 32, 32, True, 0),        # ragged tiles
    (1, 256, 384, 4, 2, 128, 128, False, 0),     # non-causal, S_q != S_k
    (1, 512, 512, 4, 1, 256, 256, True, 128),    # window, MQA, hd 256
    (1, 256, 256, 4, 4, 192, 128, True, 0),      # MLA's (192, 128), padded to 256
    (1, 256, 256, 4, 2, 112, 112, True, 0),      # kimi-k2's 112, padded to 128
]


def _check_bwd(got, want, dtype):
    want = want.float()
    diff = (got.float() - want).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 2e-5 * float(want.abs().max())
    else:
        torch.testing.assert_close(got.float(), want, rtol=0.06, atol=0.06)
        scale = torch.maximum(torch.maximum(want.abs(), want.pow(2).mean(-1, keepdim=True).sqrt()),
                              want.pow(2).mean().sqrt())
        assert (diff <= 4 * torch.finfo(torch.bfloat16).eps * scale).all()


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,hdv,causal,window", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_kernel_matches_plain(cuda, b, sq, sk, h, kv, hd, hdv, causal,
                                                       window, dtype):
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_with_lse
    from repro_torch.models.flash import _flash_bwd, _flash_fwd_impl
    gen = torch.Generator().manual_seed(sq + sk + hd + hdv)
    q, k, v, do = (torch.randn(shape, generator=gen).to(cuda, dtype)
                   for shape in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hdv),
                                 (b, sq, h, hdv)))
    out, lse = flash_attention_with_lse(q, k, v, causal=causal, window=window)
    # the log-sum-exp output leaves the forward's out bit for bit
    assert torch.equal(out, flash_attention(q, k, v, causal=causal, window=window))
    _, lse_plain = _flash_fwd_impl(q, k, v, causal, window, sq, sk)
    torch.testing.assert_close(lse, lse_plain, rtol=1e-5, atol=1e-5)
    reset_launch_counts()
    grads = flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
    assert launch_counts()["flash_attention_bwd"] == 1
    want = _flash_bwd(causal, window, sq, sk, (q, k, v, out, lse), do)
    for g, w, t in zip(grads, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == dtype
        _check_bwd(g, w, dtype)
    # no atomics: the same bits on every launch
    assert all(torch.equal(a, c) for a, c in
               zip(grads, flash_attention_bwd(q, k, v, out, do, lse, causal=causal,
                                              window=window)))


def test_flash_attention_autograd_runs_the_kernels(cuda):
    """Under autograd the op's forward writes the log-sum-exp and its
    backward is the hand-written kernel (one launch each), never a plain
    path; without a gradient the forward-only launch runs."""
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda, torch.bfloat16).requires_grad_(True)
               for shape in ((2, 128, 8, 64), (2, 128, 2, 64), (2, 128, 2, 64)))
    reset_launch_counts()
    out = flash_attention(q, k, v)
    out.float().square().sum().backward()
    assert launch_counts()["flash_attention"] == 1
    assert launch_counts()["flash_attention_bwd"] == 1
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    assert flash_attention_bwd.routes == {"bf16_tensor_cores": 1, "f32_cuda_cores": 0}
    with torch.no_grad():
        flash_attention(q, k, v)
    assert launch_counts()["flash_attention_bwd"] == 1


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-236b", "falcon-mamba-7b",
                                  "recurrentgemma-2b", "seamless-m4t-medium"])
def test_training_step_on_the_card_matches_the_cpu(cuda, arch):
    """A float32 training step of each family's smoke LM on the card against
    the same step on the CPU: loss within 1e-5 (relative), grad_norm within
    1e-4 (relative) and each gradient leaf's max |card - cpu| within 5e-4 of
    its max |cpu| (the bounds of ``chip_smoke.py``'s float32 step); the card
    runs the forward and backward kernels.  The optimizer's update is held
    on its own: the CPU's clipped gradients fed to ``opt.update`` on both
    devices from the same params and fresh state give new params and state
    whose leaves are within 1e-6 of the leaf's max |cpu| (the whole step's
    params are not compared: at step 1 Adam moves a leaf by about
    lr · sign(g), so the card's gradient error moves near-zero entries by up
    to 2 · lr)."""
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.interop import stacked_groups
    from repro_torch.train.optimizer import clip_by_global_norm, get_optimizer
    from repro_torch.train.trainer import TrainConfig, make_train_state, make_train_step
    from repro_torch.train.tree import tree_leaves, tree_unflatten
    def fresh(device):      # the same float32 weights, new tensors (steps update in place)
        return _to(get_model(arch, smoke=True, device="cpu").init(0), device)

    runs = {}
    for device in ("cpu", "cuda"):
        api = get_model(arch, smoke=True, device=device)
        params = fresh(device)
        groups = [n for n, c in stacked_groups(api.cfg).items() if c]
        state = make_train_state(params, get_optimizer(api.cfg.optimizer), groups)
        batch = next(lm_batches(api.cfg.vocab, 2, 64, seed=0,
                                frames_dim=api.cfg.d_model if api.cfg.family == "encdec"
                                else None))
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        grads = torch.autograd.grad(api.loss(state.params, batch), tree_leaves(state.params))
        clipped, gnorm = clip_by_global_norm(list(grads), 1.0)
        step = make_train_step(api.loss, TrainConfig(optimizer=api.cfg.optimizer,
                                                     peak_lr=1e-3, total_steps=10, warmup=2))
        reset_launch_counts()
        _, m = step(state, batch)
        runs[device] = (m, float(gnorm), [g.cpu() for g in grads], launch_counts(),
                        [g.cpu() for g in clipped])
    (m_cpu, n_cpu, g_cpu, _, clip_cpu), (m_gpu, n_gpu, g_gpu, counts, _) = \
        runs["cpu"], runs["cuda"]
    assert m_gpu["skipped"] == 0.0 and abs(m_gpu["grad_norm"] - n_gpu) <= 1e-6 * n_gpu
    assert abs(m_gpu["loss"] - m_cpu["loss"]) <= 1e-5 * abs(m_cpu["loss"])
    assert abs(m_gpu["grad_norm"] - m_cpu["grad_norm"]) <= 1e-4 * m_cpu["grad_norm"]
    for a, c in zip(g_gpu, g_cpu):
        assert float((a - c).abs().max()) <= 5e-4 * max(float(c.abs().max()), 1e-30)
    if arch != "falcon-mamba-7b":                       # mamba has no attention
        assert counts["flash_attention"] > 0 and counts["flash_attention_bwd"] > 0

    updated = {}
    for device in ("cpu", "cuda"):
        cfg = get_model(arch, smoke=True, device=device).cfg
        opt = get_optimizer(cfg.optimizer)
        state = make_train_state(fresh(device), opt,
                                 [n for n, c in stacked_groups(cfg).items() if c])
        opt.update(tree_unflatten(state.params, [g.to(device) for g in clip_cpu]),
                   state.opt_state, state.params, 1e-3, state.stacked)
        updated[device] = [t.detach().cpu().double() for t in
                           tree_leaves(state.params) + tree_leaves(state.opt_state)]
    for a, c in zip(updated["cuda"], updated["cpu"]):
        assert float((a - c).abs().max()) <= 1e-6 * max(float(c.abs().max()), 1e-30)
