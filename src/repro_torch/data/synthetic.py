"""Synthetic data (numpy copy of ``repro.data.synthetic``).

``make_sparse_classification`` draws sparse design matrices statistically
matched to the paper's Table-2 datasets (N, D, nnz/row, an informative
subset, and optionally a URL-style dense informative block).  Labels come
from a planted sparse logistic model.  ``with_repeated_entries`` lists some
of a matrix's entries a second time (a row that holds a column twice, as a
LIBSVM line may).  ``lm_batches`` streams token batches
from a sparse random bigram chain (``make_markov_chain``) for the LM.  The
same seed gives the same matrix, labels and tokens as the JAX package's
generators.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.core.sparse.formats import HostCSR, coo_to_host


def make_sparse_classification(
    n: int, d: int, nnz_per_row: float, informative: int,
    dense_features: int = 0, seed: int = 0, label_noise: float = 0.05,
) -> Tuple[HostCSR, np.ndarray, np.ndarray]:
    """Returns (X as HostCSR with values in [-1, 1], y ∈ {0,1}, true_w)."""
    rng = np.random.default_rng(seed)
    rows_list, cols_list, vals_list = [], [], []
    # heavy-tailed column popularity (text-like power law)
    col_p = 1.0 / np.arange(1, d + 1) ** 1.1
    col_p /= col_p.sum()

    nnz_row = np.maximum(1, rng.poisson(max(nnz_per_row - dense_features, 1), size=n))
    for i in range(n):
        k = min(int(nnz_row[i]), d)
        cols = rng.choice(d, size=k, replace=False, p=col_p) if d <= 200_000 else \
            np.unique(rng.zipf(1.3, size=k) % d)
        vals = rng.uniform(0.1, 1.0, size=cols.shape[0]) * rng.choice([-1.0, 1.0], size=cols.shape[0])
        rows_list.append(np.full(cols.shape[0], i))
        cols_list.append(cols)
        vals_list.append(vals)
    if dense_features:
        # URL-style: a dense informative block occupying the first columns
        dense_vals = np.clip(rng.normal(0, 0.5, size=(n, dense_features)), -1, 1)
        for j in range(dense_features):
            rows_list.append(np.arange(n))
            cols_list.append(np.full(n, j))
            vals_list.append(dense_vals[:, j])
    rows = np.concatenate(rows_list)
    cols = np.concatenate(cols_list)
    vals = np.concatenate(vals_list)
    # tf-idf-style column scaling + row normalization, matching the LIBSVM
    # preprocessing of the paper's datasets.  Without idf, the power-law-head
    # (dense) columns carry large CLT-noise gradients and Frank-Wolfe zig-zags
    # on them forever — real text data downweights frequent terms, which is
    # exactly what makes the paper's sparse updates pay off.
    df = np.bincount(cols, minlength=d).astype(np.float64)
    idf = np.log1p(n / np.maximum(df, 1.0))
    idf /= idf.max()
    is_text = cols >= dense_features  # the URL-style dense block skips idf
    vals = np.where(is_text, vals * idf[cols], vals)
    # unit-L2 rows (liblinear convention); keeps |x_ij| ≤ 1 for the DP
    # sensitivity bound
    sq = np.bincount(rows, weights=vals ** 2, minlength=n)
    norm = np.sqrt(np.maximum(sq, 1e-12))
    vals = vals / norm[rows]
    X = coo_to_host(rows, cols, vals, (n, d))

    # planted sparse weight vector.  Informative columns are drawn from the
    # *middle* of the popularity distribution (log-spread between rank ~10 and
    # D/4): real text corpora carry signal in moderately-frequent terms, not
    # only the few densest columns.  Planting on arange(informative) (= the
    # power-law head) makes every FW pick a near-dense column and erases the
    # sparse-update advantage — the paper's URL phenomenon, which we model
    # explicitly via ``dense_features`` instead.
    true_w = np.zeros(d)
    if dense_features:
        # URL-style: signal rides on the dense block
        info_idx = np.arange(min(informative, d))
    else:
        lo, hi = min(10, d - 1), max(d // 4, min(10, d - 1) + 1)
        cand = np.unique(np.geomspace(lo, hi, num=4 * informative).astype(int))
        info_idx = rng.choice(cand, size=min(informative, cand.shape[0]),
                              replace=False)
    true_w[info_idx] = rng.normal(0, 2.0, size=info_idx.shape[0])
    margins = X.matvec(true_w)
    p = 1.0 / (1.0 + np.exp(-margins))
    y = (rng.random(n) < p).astype(np.float64)
    flip = rng.random(n) < label_noise
    y[flip] = 1.0 - y[flip]
    return X, y, true_w


def with_repeated_entries(X: HostCSR, rows, cols, seed: int) -> HostCSR:
    """A copy of ``X`` in which each entry (rows[k], cols[k]) — one X holds —
    is listed once more, at a random lane of its row, with a new value in
    ±[0.5, 1.5) (X's own entries keep their order)."""
    rng = np.random.default_rng(seed)
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    for i, c in zip(rows, cols):
        if c not in X.row(int(i))[0]:
            raise ValueError(f"row {i} holds no entry in column {c}")
    lens = np.diff(X.indptr)
    at = X.indptr[rows] + rng.integers(0, lens[rows] + 1)
    vals = rng.uniform(0.5, 1.5, rows.size) * rng.choice([-1.0, 1.0], rows.size)
    added = np.bincount(rows, minlength=X.shape[0])
    indptr = X.indptr + np.concatenate([[0], np.cumsum(added)])
    return HostCSR(indptr, np.insert(X.indices, at, cols), np.insert(X.data, at, vals),
                   X.shape)


def make_markov_chain(vocab: int, seed: int, branching: int = 8):
    """Sparse random bigram transition table: token -> `branching` successors."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, size=(vocab, branching))
    logits = rng.normal(0, 1, size=(vocab, branching))
    probs = np.exp(logits)
    probs /= probs.sum(axis=1, keepdims=True)
    return succ, probs


def lm_batches(vocab: int, batch: int, seq: int, seed: int = 0,
               frames_dim: Optional[int] = None,
               enc_frac: float = 0.5) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite stream of {"tokens": (B,S) int32} (+ "frames" for enc-dec).

    The JAX package's stream, token for token: its ``rng.choice(branching,
    p=probs[c])`` per row draws one uniform u and takes the first index whose
    normalised cumulative probability exceeds u; here the B rows' uniforms
    are drawn at once (the same numbers, in the same order) and compared
    with the same cumulative sums, so a position costs a few array ops, not
    B Python calls."""
    succ, probs = make_markov_chain(vocab, seed)
    cdf = probs.cumsum(axis=1)
    cdf /= cdf[:, -1:]
    rng = np.random.default_rng(seed + 1)
    while True:
        toks = np.empty((batch, seq), dtype=np.int32)
        cur = rng.integers(0, vocab, size=batch)
        for t in range(seq):
            toks[:, t] = cur
            choice = (cdf[cur] <= rng.random(batch)[:, None]).sum(axis=1)
            cur = succ[cur, choice]
        out = {"tokens": toks}
        if frames_dim is not None:
            s_enc = int(seq * enc_frac)
            out["frames"] = rng.normal(0, 1, size=(batch, s_enc, frames_dim)).astype(np.float32)
        yield out
