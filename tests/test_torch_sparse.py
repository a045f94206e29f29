"""The port's sparse plane pieces against the reference's, on the CPU.

- `IndexedRows` in the reference's v2 frame: byte-equal to the
  reference codec's frame of the same tree; in the port's own frame it
  round-trips. `merge_indexed_rows` with and without dedup: bit-equal.
- `SparseOptimizer`, all four kinds: rows and slots bit-equal to the
  reference's over three steps of the same rows (repeated ids included).
- `prepare_batch_embedding`, `embedding_forward` (every combiner, with
  and without mask_zero) and `extract_indexed_grads` against
  `elasticdl_tpu/api/layers.py` through `jax.grad`: the BET bit-equal,
  the forward and the BET gradient within 1e-6 (float32; the same
  formulas, other summation orders).
- `auc_state` over several minibatches, merged: the bin counts equal the
  reference's, and so does the finalized AUC.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from elasticdl_tpu.api import layers as jlayers  # noqa: E402
from elasticdl_tpu.api import metrics as jmetrics  # noqa: E402
from elasticdl_tpu.common import codec as jcodec  # noqa: E402
from elasticdl_tpu.master import embedding_store as jstore  # noqa: E402
from elasticdl_tpu.master import sparse_optimizer as jsparse  # noqa: E402
from elasticdl_tpu_torch.api import layers as tlayers  # noqa: E402
from elasticdl_tpu_torch.api import metrics as tmetrics  # noqa: E402
from elasticdl_tpu_torch.common import codec as tcodec  # noqa: E402
from elasticdl_tpu_torch.master import embedding_store as tstore  # noqa: E402
from elasticdl_tpu_torch.master import sparse_optimizer as tsparse  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401 (autouse fixture)

F32_ATOL = 1e-6


def _rows(rng, n, dim, vocab=20):
    return (rng.standard_normal((n, dim)).astype(np.float32),
            rng.integers(0, vocab, size=n).astype(np.int64))


@pytest.mark.parametrize("n", [0, 1, 7])
def test_indexed_rows_frames_are_the_references_bytes(n):
    rng = np.random.default_rng(n)
    v, i = _rows(rng, n, 8)
    tree = {"edl_gradient": {"fm_second": (v, i), "fm_first": (v[:, :1].copy(), i)},
            "version": 3, "steps": [1, 2]}
    port = {**tree, "edl_gradient": {k: tcodec.IndexedRows(*a) for k, a in tree["edl_gradient"].items()}}
    ref = {**tree, "edl_gradient": {k: jcodec.IndexedRows(*a) for k, a in tree["edl_gradient"].items()}}
    frame = tcodec.dumps_v2(port)
    assert frame == jcodec.dumps(ref)
    for back in (tcodec.loads(frame), tcodec.loads(tcodec.dumps(port))):
        for k, rows in port["edl_gradient"].items():
            got = back["edl_gradient"][k]
            assert isinstance(got, tcodec.IndexedRows)
            assert got.values.tobytes() == rows.values.tobytes()
            assert got.indices.dtype == np.int64 and got.indices.tobytes() == rows.indices.tobytes()
    # the reference decodes the port's v2 frame to its own IndexedRows
    got = jcodec.loads(frame)["edl_gradient"]["fm_second"]
    assert isinstance(got, jcodec.IndexedRows) and got.values.tobytes() == v.tobytes()


def test_embedding_snapshot_with_int_keys_is_the_references_frame():
    rng = np.random.default_rng(1)
    snap = {"t": {int(k): rng.standard_normal(4).astype(np.float32) for k in (5, 1, 99)},
            "t/slot/m": {1: np.zeros(4, np.float32)}}
    frame = tcodec.dumps_v2({"version": 2, "embeddings": snap})
    assert frame == jcodec.dumps({"version": 2, "embeddings": snap})
    back = tcodec.loads(frame)["embeddings"]
    assert list(back["t"]) == [5, 1, 99]
    assert back["t"][99].tobytes() == snap["t"][99].tobytes()
    with pytest.raises(TypeError):
        tcodec.dumps(snap)  # the JSON header takes string keys only


@pytest.mark.parametrize("dedup", [False, True])
def test_merge_indexed_rows_is_the_references(dedup):
    rng = np.random.default_rng(2)
    parts = [_rows(rng, n, 4, vocab=9) for n in (5, 0, 11, 3)]
    got = tcodec.merge_indexed_rows([tcodec.IndexedRows(*p) for p in parts], dedup=dedup)
    want = jcodec.merge_indexed_rows([jcodec.IndexedRows(*p) for p in parts], dedup=dedup)
    assert got.indices.tobytes() == want.indices.tobytes()
    assert got.values.dtype == want.values.dtype and got.values.tobytes() == want.values.tobytes()
    empty = tcodec.merge_indexed_rows([tcodec.IndexedRows(np.zeros((0, 4), np.float32), [])], dedup=True)
    assert empty.values.shape == (0, 4) and empty.indices.size == 0


@pytest.mark.parametrize("kind, kw", [
    ("sgd", {"learning_rate": 0.1}),
    ("momentum", {"learning_rate": 0.05, "momentum": 0.9}),
    ("momentum", {"learning_rate": 0.05, "momentum": 0.9, "nesterov": True}),
    ("adam", {"learning_rate": 1e-2}),
    ("amsgrad", {"learning_rate": 1e-2}),
], ids=["sgd", "momentum", "nesterov", "adam", "amsgrad"])
def test_sparse_optimizer_rows_and_slots_are_the_references(kind, kw):
    rng = np.random.default_rng(3)
    port_store, ref_store = tstore.NativeEmbeddingStore(), jstore.PyEmbeddingStore()
    ids = np.arange(1, 16, dtype=np.int64)
    for layer, dim in (("a", 8), ("b", 1)):
        init = rng.uniform(-0.05, 0.05, (len(ids), dim)).astype(np.float32)
        port_store.update(layer, ids, init)
        ref_store.update(layer, ids, init)
    port = tsparse.SparseOptimizer(port_store, kind=kind, **kw)
    ref = jsparse.SparseOptimizer(ref_store, kind=kind, **kw)
    assert port.slot_names == ref.slot_names
    for _ in range(3):
        grads = {}
        for layer, dim in (("a", 8), ("b", 1)):
            idx = rng.choice(ids, size=12)  # repeated ids: dedup sums them
            grads[layer] = rng.standard_normal((12, dim)).astype(np.float32), idx
        port.apply_gradients({k: tcodec.IndexedRows(*g) for k, g in grads.items()})
        ref.apply_gradients({k: jcodec.IndexedRows(*g) for k, g in grads.items()})
    want, got = ref_store.snapshot(), port_store.snapshot()
    assert sorted(got) == sorted(want)
    assert {f"a/slot/{s}" for s in ref.slot_names} <= set(got)
    for layer in want:
        assert sorted(got[layer]) == sorted(want[layer])
        for i in want[layer]:
            assert got[layer][i].tobytes() == want[layer][i].tobytes(), (layer, i)
    # a gradient for rows never initialized is refused, as the reference refuses it
    with pytest.raises(ValueError):
        port.apply_gradients({"a": tcodec.IndexedRows(np.ones((1, 8), np.float32), [999])})


def _lookup(spec, uniq):
    # deterministic rows by id, no store
    return np.stack([np.full(spec.dim, 0.01 * i, np.float32) + np.arange(spec.dim) * 1e-3
                     for i in uniq]) if len(uniq) else np.zeros((0, spec.dim), np.float32)


@pytest.mark.parametrize("combiner", [None, "sum", "mean", "sqrtn"])
@pytest.mark.parametrize("mask_zero", [False, True])
@pytest.mark.parametrize("shape", [(6,), (5, 4)])
def test_bet_forward_and_gradient_are_the_references(combiner, mask_zero, shape):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 7, size=shape)
    tspec = tlayers.EmbeddingSpec("t", 3, "ids", combiner=combiner, mask_zero=mask_zero)
    jspec = jlayers.EmbeddingSpec("t", 3, "ids", combiner=combiner, mask_zero=mask_zero)
    got = tlayers.prepare_batch_embedding(tspec, ids, _lookup)
    want = jlayers.prepare_batch_embedding(jspec, ids, _lookup)
    for f in ("bet", "inverse", "mask", "ids"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), f
    assert got.bet.shape[0] == tlayers.bucket_size(len(got.ids)) == jlayers.bucket_size(len(got.ids))
    w = rng.standard_normal((1, 3) if combiner else (1, 1, 3)).astype(np.float32)

    def jloss(bet):
        out = jlayers.embedding_forward(bet, want.inverse, want.mask, combiner)
        return jnp.sum(out * w), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(want.bet))
    bet = torch.from_numpy(got.bet.copy()).requires_grad_(True)
    out = tlayers.embedding_forward(bet, torch.from_numpy(got.inverse),
                                    torch.from_numpy(got.mask), combiner)
    (tgrad,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), bet)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), atol=F32_ATOL, rtol=0)
    # the padded rows get no gradient
    assert not tgrad.numpy()[len(got.ids):].any()
    rows = tlayers.extract_indexed_grads(tspec, tgrad.numpy(), got)
    jrows = jlayers.extract_indexed_grads(jspec, np.asarray(jgrad), want)
    assert rows.indices.tobytes() == jrows.indices.tobytes()
    np.testing.assert_allclose(rows.values, jrows.values, atol=F32_ATOL, rtol=0)
    if mask_zero:
        assert 0 not in rows.indices.tolist()


def test_auc_state_merged_over_batches_is_the_references():
    rng = np.random.default_rng(6)
    port_acc = ref_acc = None
    for b in range(5):
        scores = (rng.standard_normal(64) * 2).astype(np.float32)
        labels = (rng.random(64) < 0.4).astype(np.float32)
        got = tmetrics.auc_state(torch.from_numpy(scores), torch.from_numpy(labels))
        want = jax.tree_util.tree_map(np.asarray, jmetrics.auc_state(jnp.asarray(scores), jnp.asarray(labels)))
        got = {k: v if k == "kind" else v.numpy() for k, v in got.items()}
        assert got["kind"] == want["kind"] == "auc_bins"
        for k in ("pos", "neg"):
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
        port_acc = got if port_acc is None else tmetrics.merge_metric_states(port_acc, got)
        ref_acc = want if ref_acc is None else jmetrics.merge_metric_states(ref_acc, want)
    auc = tmetrics.finalize_metric_state(port_acc)
    assert auc == jmetrics.finalize_metric_state(ref_acc)
    assert 0.3 < auc < 0.7  # random scores
