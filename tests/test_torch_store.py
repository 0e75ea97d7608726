"""The port's dataset store against the JAX package's, on the CPU.

Both packages read and write one on-disk format: LIBSVM text, the sharded
store (manifest, shards, column stats, the content hash), the padded cache
and the tuning records.  Each test writes with one package and reads with
the other, or solves from a store with both.  Each package keeps its own
setup cache (the port's ``setup-<loss>-torch-<device>.npz``) and tuning key.

Tolerances: stores, hashes, splits and parsed text equal exactly;
``solve(store)`` equals ``solve(X, y)`` in the port bit for bit, cold and
warm; the port against the JAX package's ``jax_sparse`` by the repo's
cross-engine contract (coordinates exactly, w and gaps within atol 1e-4);
``setup_streamed`` against the kernel setup at the JAX package's tolerances
(α₀ atol 1e-5, q̄₀ atol 1e-6, ``tests/test_dataset_store.py``).  Every test
points ``REPRO_DATA_DIR`` at its own directory.
"""
import io
import os

import numpy as np
import pytest
import torch

from repro.core.solvers import FWConfig as JaxConfig
from repro.core.solvers import solve as jax_solve
from repro.core.solvers.autotune import TuningRecord as JaxTuningRecord
from repro.data import registry as jax_registry
from repro.data import sparse_io as jax_io
from repro.data.store import DatasetStore as JaxStore
from repro.data.synthetic import make_sparse_classification
from repro_torch import FWConfig, obs, solve
from repro_torch.core.solvers.autotune import TuningRecord, autotune, platform_of
from repro_torch.core.solvers.prepared import PreparedDataset
from repro_torch.core.solvers.registry import as_dense, as_host_csr, as_padded
from repro_torch.core.sparse.formats import HostCSR, TieredCSC, host_to_padded
from repro_torch.data import ShardedLoader
from repro_torch.data import registry as torch_registry
from repro_torch.data import sparse_io as torch_io
from repro_torch.data.store import DatasetRef, DatasetStore

PACKAGES = {"repro": (JaxStore, jax_io), "repro_torch": (DatasetStore, torch_io)}
EXTRA_LINES = {
    False: "+1 qid:3 1:0.5 7:-2.25 # a comment\n-1 3:1e-3 3:0.25 9:-0\n"
           "# a whole comment line\n0 # label only\n\n1 2:4\n",
    True: "1 qid:1 0:0.5 6:-2.25 # a comment\n-1 2:1e-3 2:0.25\n0\n+1 0:7 0:-7\n",
}


@pytest.fixture(autouse=True)
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path / "datasets"))
    return tmp_path / "datasets"


@pytest.fixture(scope="module")
def problem():
    X, y, _ = make_sparse_classification(n=160, d=500, nnz_per_row=10, informative=15, seed=4)
    return X, y


def port_csr(X) -> HostCSR:
    return HostCSR(X.indptr, X.indices, X.data, X.shape)


def cache_counts(tel) -> dict:
    return {f"{m['labels']['cache']}_{m['labels']['outcome']}": m["value"]
            for m in tel.metrics.snapshot() if m["name"] == "store.cache"}


def assert_same_bits(got, ref, msg=""):
    for k in ("coords", "w", "gaps", "losses"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), f"{msg}: {k}"


def assert_contract(ref, got, msg=""):
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(ref.coords), err_msg=msg)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), atol=1e-4, err_msg=msg)
    np.testing.assert_allclose(got.gaps.numpy(), np.asarray(ref.gaps), atol=1e-4, err_msg=msg)


def chunks_equal(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        for k in ("y", "indptr", "cols", "vals"):
            np.testing.assert_array_equal(getattr(ca, k), getattr(cb, k), err_msg=k)
            assert getattr(ca, k).dtype == getattr(cb, k).dtype, k


# ---------------------------------------------------------------------------
# LIBSVM text
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("zero_based", [False, True])
@pytest.mark.parametrize("writer,reader", [("repro", "repro_torch"), ("repro_torch", "repro")])
def test_libsvm_text_parses_the_same_in_both_packages(problem, writer, reader, zero_based):
    """Text one package writes (plus comments, ``qid``, signs, blank lines and
    a line with a repeated index) parses to the same chunks in the other."""
    X, y = problem
    out = io.StringIO()
    x_in = X if writer == "repro" else port_csr(X)
    PACKAGES[writer][1].write_libsvm(out, x_in, y, zero_based=zero_based)
    text = out.getvalue() + EXTRA_LINES[zero_based]
    read = PACKAGES[reader][1].iter_libsvm(io.StringIO(text), chunk_rows=37,
                                           zero_based=zero_based)
    own = PACKAGES[writer][1].iter_libsvm(io.StringIO(text), chunk_rows=37,
                                          zero_based=zero_based)
    chunks_equal(read, own)
    chunks = list(torch_io.iter_libsvm(io.StringIO(text), chunk_rows=10_000,
                                       zero_based=zero_based))
    head = chunks[0]
    n = X.shape[0]
    np.testing.assert_array_equal(head.indptr[:n + 1], X.indptr)
    np.testing.assert_array_equal(head.cols[:X.nnz], X.indices)
    np.testing.assert_array_equal(head.vals[:X.nnz], X.data)     # %.17g is exact
    # the repeated index survives as two entries
    lens = np.diff(head.indptr[n:])
    assert (lens >= 2).any()


def test_libsvm_round_trip_through_the_port(problem):
    X, y = problem
    out = io.StringIO()
    torch_io.write_libsvm(out, port_csr(X), y)
    got = list(torch_io.iter_libsvm(io.StringIO(out.getvalue()), chunk_rows=50))
    ref = list(torch_io.chunks_from_arrays(port_csr(X), y, chunk_rows=50))
    chunks_equal(got, ref)
    assert list(torch_io.iter_any(port_csr(X), y, 50))[0].n_rows == 50
    with pytest.raises(ValueError, match="labels required"):
        torch_io.iter_any(port_csr(X))
    with pytest.raises(ValueError, match="underflows"):
        list(torch_io.iter_libsvm(io.StringIO("1 0:1.0\n")))


# ---------------------------------------------------------------------------
# the store across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("repro", "repro_torch"), ("repro_torch", "repro")])
def test_store_written_by_one_package_opens_in_the_other(problem, tmp_path, writer, reader):
    X, y = problem
    w_cls, r_cls = PACKAGES[writer][0], PACKAGES[reader][0]
    x_in = X if writer == "repro" else port_csr(X)
    written = w_cls.from_arrays(str(tmp_path / "s"), x_in, y, rows_per_shard=45,
                                chunk_rows=31)
    opened = r_cls.open(str(tmp_path / "s"))
    # the reader's own write of the same rows gives the same hash
    x_own = X if reader == "repro" else port_csr(X)
    own = r_cls.from_arrays(str(tmp_path / "own"), x_own, y, rows_per_shard=45, chunk_rows=31)
    assert opened.content_hash == written.content_hash == own.content_hash
    skip = {"created_unix"}
    assert ({k: v for k, v in own.manifest.items() if k not in skip}
            == {k: v for k, v in written.manifest.items() if k not in skip})
    assert opened.n_shards == written.n_shards == 4
    for i in range(opened.n_shards):
        a, b = opened.shard(i), written.shard(i)
        for k in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
            assert getattr(a, k).dtype == getattr(b, k).dtype
        np.testing.assert_array_equal(opened.shard_labels(i), written.shard_labels(i))
    sa, sb = opened.col_stats(), written.col_stats()
    for k in ("df", "norm_sq", "col_sum", "col_y_sum"):
        np.testing.assert_array_equal(getattr(sa, k), getattr(sb, k))
    for frac, salt in ((0.2, 0), (0.35, 7)):
        for a, b in zip(opened.split(frac, salt), written.split(frac, salt)):
            np.testing.assert_array_equal(a, b)
    rows = np.array([5, 150, 0, 44, 45, 5, 99])
    (xa, ya), (xb, yb) = opened.take(rows), written.take(rows)
    for k in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(xa, k), getattr(xb, k))
    np.testing.assert_array_equal(ya, yb)
    np.testing.assert_array_equal(opened.labels(), y)
    host = opened.to_host_csr()
    np.testing.assert_array_equal(host.indices, X.indices)
    np.testing.assert_array_equal(host.data, X.data)


@pytest.mark.parametrize("rows_per_shard,chunk_rows", [(1, 7), (37, 5), (160, 160), (1000, 64)])
def test_content_hash_is_the_jax_packages_at_every_shard_size(problem, tmp_path, rows_per_shard,
                                                              chunk_rows):
    X, y = problem
    ref = JaxStore.from_arrays(str(tmp_path / "jax"), X, y, rows_per_shard=50)
    got = DatasetStore.from_arrays(str(tmp_path / "port"), port_csr(X), y,
                                   rows_per_shard=rows_per_shard, chunk_rows=chunk_rows)
    assert got.content_hash == ref.content_hash
    assert got.n_shards == -(-X.shape[0] // rows_per_shard)


def test_libsvm_file_ingests_to_the_same_store_in_both_packages(problem, tmp_path):
    X, y = problem
    path = str(tmp_path / "x.libsvm")
    jax_io.write_libsvm(path, X, y)
    a = JaxStore.write(str(tmp_path / "a"), jax_io.iter_libsvm(path, chunk_rows=40),
                       n_cols=X.shape[1], rows_per_shard=64)
    b = DatasetStore.write(str(tmp_path / "b"), torch_io.iter_libsvm(path, chunk_rows=23),
                           n_cols=X.shape[1], rows_per_shard=50)
    assert a.content_hash == b.content_hash
    np.testing.assert_array_equal(b.to_host_csr().data, X.data)


# ---------------------------------------------------------------------------
# solve(store) in the port
# ---------------------------------------------------------------------------

SOLVES = {
    "torch_sparse_private": dict(backend="torch_sparse", queue="two_level"),
    "torch_sparse": dict(backend="torch_sparse", queue="group_argmax"),
    "dense": dict(backend="dense"),
}


def _cfg(name, **kw):
    return FWConfig(lam=8.0, steps=30, epsilon=1.0, delta=1e-6, device="cpu",
                    **SOLVES[name], **kw)


@pytest.mark.parametrize("name", list(SOLVES))
def test_store_solve_equals_in_memory_solve_cold_and_warm(problem, tmp_path, name):
    X, y = problem
    root = str(tmp_path / "s")
    DatasetStore.from_arrays(root, port_csr(X), y, rows_per_shard=48)
    cfg = _cfg(name)
    ref = solve(port_csr(X), y, cfg)
    sparse = name.startswith("torch_sparse")
    for phase in ("cold", "warm"):
        with obs.session() as tel:
            got = solve(DatasetStore.open(root), config=cfg)
        assert_same_bits(got, ref, f"{name} {phase}")
        want = {} if not sparse else (
            {"padded_miss": 1, "setup_miss": 1, "autotune_miss": 1} if phase == "cold"
            else {"padded_hit": 1, "setup_hit": 1, "autotune_miss": 1})
        assert cache_counts(tel) == want, phase
    files = sorted(os.listdir(os.path.join(root, "cache")))
    if sparse:
        assert "setup-logistic-torch-cpu.npz" in files and "padded-meta.json" in files
    else:
        assert files == []


@pytest.mark.parametrize("loss", ["logistic", "huber"])
def test_store_solve_takes_the_jax_packages_coordinates(problem, tmp_path, loss):
    """A store that ``repro`` wrote: the port's ``solve(store)`` against the
    JAX package's ``jax_sparse`` from the same store, private and not."""
    X, y = problem
    root = str(tmp_path / "s")
    JaxStore.from_arrays(root, X, y, rows_per_shard=64)
    for queue in ("two_level", "group_argmax"):
        kw = dict(lam=8.0, steps=30, loss=loss, queue=queue, epsilon=1.0, delta=1e-6)
        ref = jax_solve(JaxStore.open(root), config=JaxConfig(backend="jax_sparse", **kw))
        got = solve(DatasetStore.open(root), config=FWConfig(backend="torch_sparse",
                                                             device="cpu", **kw))
        assert_contract(ref, got, f"{loss} {queue}")


def test_each_package_keeps_its_own_setup_cache(problem, tmp_path):
    """The JAX package's setup file never reaches the port, the port's never
    changes the JAX package's iterates; the padded cache is shared."""
    X, y = problem
    root = str(tmp_path / "s")
    JaxStore.from_arrays(root, X, y, rows_per_shard=64)
    kw = dict(lam=8.0, steps=30, queue="two_level", epsilon=1.0, delta=1e-6)
    jax_first = jax_solve(JaxStore.open(root), config=JaxConfig(backend="jax_sparse", **kw))
    cache = os.path.join(root, "cache")
    jax_setup = [f for f in os.listdir(cache) if f.startswith("setup-")]
    assert jax_setup == ["setup-logistic-interp.npz"]
    with open(os.path.join(cache, jax_setup[0]), "rb") as f:
        jax_bytes = f.read()
    cfg = FWConfig(backend="torch_sparse", device="cpu", **kw)
    with obs.session() as tel:
        got = solve(DatasetStore.open(root), config=cfg)
    # the padded lanes the JAX package cached are the port's own
    assert cache_counts(tel) == {"padded_hit": 1, "setup_miss": 1, "autotune_miss": 1}
    assert_same_bits(got, solve(port_csr(X), y, cfg), "port from a JAX-cached store")
    assert sorted(f for f in os.listdir(cache) if f.startswith("setup-")) == [
        "setup-logistic-interp.npz", "setup-logistic-torch-cpu.npz"]
    with open(os.path.join(cache, jax_setup[0]), "rb") as f:
        assert f.read() == jax_bytes
    again = jax_solve(JaxStore.open(root), config=JaxConfig(backend="jax_sparse", **kw))
    for k in ("coords", "w", "gaps"):
        np.testing.assert_array_equal(np.asarray(getattr(again, k)),
                                      np.asarray(getattr(jax_first, k)), err_msg=k)


def test_the_jax_package_reads_the_ports_padded_cache(problem, tmp_path):
    X, y = problem
    root = str(tmp_path / "s")
    DatasetStore.from_arrays(root, port_csr(X), y, rows_per_shard=64).prepared("cpu")
    import repro.obs as jax_obs
    kw = dict(lam=8.0, steps=30, queue="group_argmax")
    with jax_obs.session() as tel:
        got = jax_solve(JaxStore.open(root), config=JaxConfig(backend="jax_sparse", **kw))
    assert cache_counts(tel)["padded_hit"] == 1
    ref = jax_solve(X, y, JaxConfig(backend="jax_sparse", **kw))
    for k in ("coords", "w", "gaps"):
        np.testing.assert_array_equal(np.asarray(getattr(got, k)), np.asarray(getattr(ref, k)))


def test_a_jax_tuning_record_does_not_steer_the_port(problem, tmp_path):
    X, y = problem
    root = str(tmp_path / "s")
    jstore = JaxStore.from_arrays(root, X, y, rows_per_shard=64)
    width = 4
    for backend in ("jax_sparse", "torch_sparse"):
        jstore.autotune_save(JaxTuningRecord(
            content_hash=jstore.content_hash, platform="cpu", backend=backend,
            loss="logistic", ell_width=width, chunk_steps=7))
    store = DatasetStore.open(root)
    cfg = FWConfig(backend="torch_sparse", lam=8.0, steps=30, device="cpu", queue="two_level")
    got = solve(store, config=cfg)
    prep = store.prepared("cpu")
    assert platform_of("cpu") == "torch-cpu"
    assert prep.tuning_for("torch_sparse", "logistic") is None and not prep._tuned_csc
    assert_same_bits(got, solve(port_csr(X), y, cfg), "untuned")
    # the port reads the JAX package's record format under the JAX key ...
    rec = store.autotune_load("jax_sparse", "logistic", "cpu")
    assert rec is not None and rec.ell_width == width
    # ... and applies a record only under its own platform key
    store.autotune_save(TuningRecord(content_hash=store.content_hash, platform="torch-cpu",
                                     backend="torch_sparse", loss="logistic",
                                     ell_width=width, chunk_steps=7))
    fresh = DatasetStore.open(root)
    tuned = solve(fresh, config=cfg)
    assert isinstance(fresh.prepared("cpu")._tuned_csc[width], TieredCSC)
    np.testing.assert_array_equal(tuned.coords.numpy(), got.coords.numpy())
    np.testing.assert_allclose(tuned.gaps.numpy(), got.gaps.numpy(), atol=1e-6)


@pytest.mark.parametrize("loss", ["logistic", "huber"])
def test_setup_streamed_matches_the_kernel_setup(problem, tmp_path, loss):
    X, y = problem
    store = DatasetStore.from_arrays(str(tmp_path / "s"), port_csr(X), y, rows_per_shard=64)
    v0, q0, a0 = store.setup_streamed(loss, device="cpu")
    kv, kq, ka = store.prepared("cpu").setup_for(y, loss)
    np.testing.assert_allclose(a0.numpy(), ka.numpy(), atol=1e-5)
    np.testing.assert_allclose(q0.numpy(), kq.numpy(), atol=1e-6)
    assert not bool(v0.any()) and a0.dtype == q0.dtype == torch.float32
    # the JAX package's streamed setup from the same store
    jv, jq, ja = JaxStore.open(store.root).setup_streamed(loss)
    np.testing.assert_allclose(a0.numpy(), np.asarray(ja), atol=1e-7)
    np.testing.assert_array_equal(q0.numpy(), np.asarray(jq))


def test_setup_cache_ignores_foreign_labels(problem, tmp_path):
    X, y = problem
    prep = DatasetStore.from_arrays(str(tmp_path / "s"), port_csr(X), y).prepared("cpu")
    cached = prep.setup_for(y, "logistic")
    fresh = prep.setup_for(1.0 - y, "logistic")
    assert not torch.equal(cached[2], fresh[2])
    assert torch.equal(prep.setup_for(torch.as_tensor(y), "logistic")[2], cached[2])


def test_padded_cache_replays_the_padded_pair(problem, tmp_path):
    X, y = problem
    root = str(tmp_path / "s")
    cold = DatasetStore.from_arrays(root, port_csr(X), y, rows_per_shard=50).prepared("cpu")
    warm = DatasetStore.open(root).prepared("cpu")
    ref = host_to_padded(port_csr(X), "cpu")
    for a, b, c in zip((cold.pcsr, cold.pcsc), (warm.pcsr, warm.pcsc), ref):
        for part in ("indices", "values", "nnz"):
            assert torch.equal(getattr(a, part), getattr(c, part))
            assert torch.equal(getattr(b, part), getattr(c, part))
            getattr(b, part).add_(1)     # a warm open's tensors are its own copies
    assert torch.equal(DatasetStore.open(root).prepared("cpu").pcsc.values, ref[1].values)


# ---------------------------------------------------------------------------
# DatasetRef, the registry, coercions, what is not ported
# ---------------------------------------------------------------------------


def test_dataset_ref_by_path_and_split(problem, tmp_path):
    X, y = problem
    root = str(tmp_path / "s")
    store = DatasetStore.from_arrays(root, port_csr(X), y, rows_per_shard=64)
    cfg = _cfg("torch_sparse_private")
    assert_same_bits(solve(DatasetRef(path=root), config=cfg),
                     solve(port_csr(X), y, cfg), "path ref")
    train, test = store.split(0.25, salt=3)
    for split, rows in (("train", train), ("test", test)):
        got = solve(DatasetRef(path=root, split=split, test_frac=0.25, salt=3), config=cfg)
        xs, ys = store.take(rows)
        assert_same_bits(got, solve(xs, ys, cfg), split)
    with pytest.raises(ValueError, match="exactly one"):
        DatasetRef()
    with pytest.raises(ValueError, match="unknown split"):
        DatasetRef(path=root, split="val")


def test_registry_store_generated_by_either_package_serves_both(data_dir):
    """``rcv1_like`` generated by one package opens in the other without a
    rewrite (the spec fingerprint decides), and both solve from it."""
    jstore = jax_registry.load("rcv1_like")
    assert jstore.root == os.path.join(str(data_dir), "rcv1_like")
    stamp = jstore.manifest["created_unix"]
    store = torch_registry.load("rcv1_like")
    assert store.manifest["created_unix"] == stamp
    assert store.content_hash == jstore.content_hash
    kw = dict(lam=20.0, steps=15, queue="group_argmax")
    ref = jax_solve(jstore, config=JaxConfig(backend="jax_sparse", **kw))
    got = solve(DatasetRef(name="rcv1_like"), config=FWConfig(backend="torch_sparse",
                                                              device="cpu", **kw))
    assert_contract(ref, got, "rcv1_like")
    # the port's own generation equals the JAX package's
    X, y = torch_registry.get_spec("rcv1_like").generate()
    other = DatasetStore.from_arrays(os.path.join(str(data_dir), "port_copy"), X, y,
                                     rows_per_shard=4096)
    assert other.content_hash == jstore.content_hash
    assert torch_registry.data_root() == str(data_dir)
    assert torch_registry.available_datasets() == jax_registry.available_datasets()


def test_registry_store_the_port_generated_opens_in_the_jax_package(data_dir):
    store = torch_registry.load("rcv1_like")
    stamp = store.manifest["created_unix"]
    assert jax_registry.load("rcv1_like").manifest["created_unix"] == stamp
    assert torch_registry.load("rcv1_like").manifest["created_unix"] == stamp


def test_coercions_accept_stores_and_prepared_data(problem, tmp_path):
    X, y = problem
    store = DatasetStore.from_arrays(str(tmp_path / "s"), port_csr(X), y, rows_per_shard=40)
    prep = as_padded(store, "cpu")
    assert isinstance(prep, PreparedDataset) and as_padded(prep, "cpu") is prep
    dense = as_dense(store, "cpu")
    assert torch.equal(dense, torch.from_numpy(port_csr(X).to_dense().astype(np.float32)))
    assert as_dense(prep, "cpu") == prep.pair
    for src in (store, prep, prep.pair, port_csr(X).to_dense()):
        h = as_host_csr(src)
        np.testing.assert_array_equal(h.indptr, X.indptr)
        np.testing.assert_array_equal(h.indices, X.indices)
        np.testing.assert_allclose(h.data, X.data, rtol=1e-7)
    with pytest.raises(TypeError, match="y is required"):
        solve(port_csr(X), config=_cfg("dense"))
    with pytest.raises(TypeError):
        as_host_csr("not a matrix")


def test_store_on_cuda_without_a_card_raises(problem, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    X, y = problem
    store = DatasetStore.from_arrays(str(tmp_path / "s"), port_csr(X), y)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store.prepared()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve(store, config=FWConfig(backend="torch_sparse", steps=5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store.setup_streamed("logistic")
    assert not os.path.exists(os.path.join(store.root, "cache", "padded-meta.json"))


def test_unported_features_raise_naming_their_roadmap_item(problem, tmp_path):
    X, y = problem
    store = DatasetStore.from_arrays(str(tmp_path / "s"), port_csr(X), y)
    # the blocks cache and the sharded engine's search are ported (A12)
    from repro_torch.distributed import build_block_sparse
    assert store.blocks_load(2, 2) is None
    blocks = build_block_sparse(port_csr(X), 2, 2)
    store.blocks_save(2, 2, blocks)
    back = store.blocks_load(2, 2)
    assert all(torch.equal(getattr(back, p), getattr(blocks, p))
               for p in ("csc_rows", "csc_vals", "csr_cols", "csr_vals"))
    assert autotune(store, backend="jax_shard", device="cpu", steps=4).backend == "jax_shard"
    with pytest.raises(NotImplementedError, match="A13"):
        ShardedLoader(iter([]))
