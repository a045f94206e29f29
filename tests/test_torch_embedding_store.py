"""The port's embedding stores against the reference's, on the CPU.

Both back ends (the C++ arena, `NativeEmbeddingStore`, and the Python
dict store) behave as the reference's: lookup misses, SETNX, overwrite,
independent layers, snapshot and restore across back ends and across
packages, the dim mismatch, one SETNX winner among racing threads. The
same op sequence leaves the port's and the reference's stores equal bit
for bit. The native library builds here with g++ into the port's own
build directory.
"""

import os
import threading

import numpy as np
import pytest

from elasticdl_tpu.master import embedding_store as jstore
from elasticdl_tpu_torch.master import embedding_store as tstore
from elasticdl_tpu_torch.master.embedding_store import (
    EmbeddingStore,
    NativeEmbeddingStore,
    PyEmbeddingStore,
)

BACKENDS = [PyEmbeddingStore, NativeEmbeddingStore]


def test_native_builds_and_is_the_default(monkeypatch):
    assert tstore.load_native() is not None
    assert os.path.exists(tstore.library_path())
    assert os.path.dirname(tstore.library_path()) == tstore.BUILD_DIR
    assert isinstance(EmbeddingStore(), NativeEmbeddingStore)
    monkeypatch.setenv("EDL_TPU_NO_NATIVE_KV", "1")
    assert isinstance(EmbeddingStore(), PyEmbeddingStore)


@pytest.mark.parametrize("backend", BACKENDS)
def test_lookup_update_roundtrip(backend):
    store = backend()
    vals, unknown = store.lookup("emb", np.array([3, 7]))
    assert vals.shape == (2, 0)
    np.testing.assert_array_equal(unknown, [0, 1])
    rows = np.arange(8, dtype=np.float32).reshape(2, 4)
    store.update("emb", np.array([3, 7]), rows)
    vals, unknown = store.lookup("emb", np.array([7, 5, 3]))
    assert unknown.tolist() == [1]
    np.testing.assert_array_equal(vals[0], rows[1])
    np.testing.assert_array_equal(vals[2], rows[0])
    np.testing.assert_array_equal(vals[1], np.zeros(4))
    assert len(store) == 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_setnx_keeps_existing_rows(backend):
    store = backend()
    store.update("emb", [1], np.full((1, 3), 5.0))
    store.update("emb", [1, 2], np.zeros((2, 3), np.float32), set_if_not_exist=True)
    vals, unknown = store.lookup("emb", [1, 2])
    assert unknown.size == 0
    np.testing.assert_array_equal(vals[0], np.full(3, 5.0))
    np.testing.assert_array_equal(vals[1], np.zeros(3))
    store.update("emb", [1], np.full((1, 3), 9.0))
    vals, _ = store.lookup("emb", [1])
    np.testing.assert_array_equal(vals[0], np.full(3, 9.0))


@pytest.mark.parametrize("backend", BACKENDS)
def test_layers_are_independent(backend):
    store = backend()
    store.update("a", [0], np.ones((1, 2), np.float32))
    store.update("a/slot/m", [0], np.full((1, 2), 7.0))
    np.testing.assert_array_equal(store.lookup("a", [0])[0][0], np.ones(2))
    np.testing.assert_array_equal(store.lookup("a/slot/m", [0])[0][0], np.full(2, 7.0))


@pytest.mark.parametrize("backend", BACKENDS)
def test_snapshot_restores_into_every_backend_of_both_packages(backend):
    store = backend()
    store.update("e1", [1, 2], np.arange(6, dtype=np.float32).reshape(2, 3))
    store.update("e2", [9], np.full((1, 2), 4.0))
    snap = store.snapshot()
    assert set(snap) == {"e1", "e2"}
    for other in BACKENDS + [jstore.PyEmbeddingStore, jstore.NativeEmbeddingStore]:
        dst = other()
        dst.restore(snap)
        vals, unknown = dst.lookup("e1", [2, 1])
        assert unknown.size == 0
        np.testing.assert_array_equal(vals[0], [3, 4, 5])
        np.testing.assert_array_equal(vals[1], [0, 1, 2])
        assert len(dst) == 3


def test_native_dim_mismatch_raises():
    store = NativeEmbeddingStore()
    store.update("e", [0], np.zeros((1, 4), np.float32))
    with pytest.raises(ValueError):
        store.update("e", [1], np.zeros((1, 8), np.float32))


@pytest.mark.parametrize("backend", BACKENDS)
def test_concurrent_setnx_single_winner(backend):
    """8 threads race SETNX on the same ids with distinct fills: every
    row is exactly one thread's fill (no torn rows)."""
    store = backend()
    ids = np.arange(64)
    fills = [float(t + 1) for t in range(8)]
    barrier = threading.Barrier(8)

    def racer(fill):
        barrier.wait()
        store.update("emb", ids, np.full((64, 4), fill, np.float32), set_if_not_exist=True)

    threads = [threading.Thread(target=racer, args=(f,)) for f in fills]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    vals, unknown = store.lookup("emb", ids)
    assert unknown.size == 0
    for row in vals:
        assert row[0] in fills
        np.testing.assert_array_equal(row, np.full(4, row[0]))


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_same_ops_leave_both_packages_stores_bit_equal(native):
    """A seeded sequence of SET, SETNX (with repeated ids in one call)
    and lookups: the port's store and the reference's end bit-equal,
    and every lookup on the way answers the same."""
    port = NativeEmbeddingStore() if native else PyEmbeddingStore()
    ref = jstore.NativeEmbeddingStore() if native else jstore.PyEmbeddingStore()
    rng = np.random.default_rng(4)
    for step in range(40):
        layer = ("t", "t/slot/m", "u")[step % 3]
        dim = 1 if layer == "u" else 4
        ids = rng.integers(0, 50, size=int(rng.integers(1, 12)))
        if step % 4 == 3:
            want, got = ref.lookup(layer, ids), port.lookup(layer, ids)
            for w, g in zip(want, got):
                assert w.dtype == g.dtype and w.tobytes() == g.tobytes()
            continue
        vals = rng.standard_normal((len(ids), dim)).astype(np.float32)
        setnx = bool(step % 2)
        ref.update(layer, ids, vals, set_if_not_exist=setnx)
        port.update(layer, ids, vals, set_if_not_exist=setnx)
    want, got = ref.snapshot(), port.snapshot()
    assert len(port) == len(ref)
    assert sorted(got) == sorted(want)
    for layer in want:
        assert sorted(got[layer]) == sorted(want[layer])
        for i in want[layer]:
            assert got[layer][i].tobytes() == want[layer][i].tobytes()
