"""The deepfm zoo and its jobs against the reference's, on the CPU.

- Tabular records: the codec and `write_synthetic_tabular_records` (the
  same draws for one seed) byte for byte; `recordio_gen/tabular`'s CLI
  writes the reference CLI's shards and meta.json byte for byte (libfm
  and CSV).
- Both models: flax's tree, shapes and dtypes; constant leaves (biases)
  bit for bit; kernels truncated normals (lecun_normal) and tables
  normals of variance 1 / dim (jax.random's streams cannot be drawn with
  numpy). From the same parameters the logits, the dense gradients and
  the BET gradients of the mean loss equal the reference's within
  `F32_REL` of their largest magnitude (float32; measured <= 2.4e-7).
- deepfm_edl_embedding jobs in-process from the same init, one worker,
  the port against the reference: per-step, window W 1 and W 4 (syncs
  blocking, `overlap_sync="off"`, so every flush lands before the next
  lookup). Versions, applied steps and the store's keys (rows and Adam
  slots) equal the reference's exactly; dense parameters and store rows
  within `JOB_ATOL` (measured: dense <= 1.2e-6, rows <= 8e-9; float32
  summation orders in the device step, while the sparse apply and the
  lazy-init draws are bit for bit); the window at W 1 equals the
  per-step job within `JOB_ATOL` (measured equal).
  With BET prefetch on (sync depth 2) the job keeps the exactness block
  and the same store keys.
- `convert` carries a reference job's deepfm parameters and tables into
  the port bit for bit.
"""

import os
import shutil

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from elasticdl_tpu.api.model_spec_helpers import spec_from_module as jspec_from_module  # noqa: E402
from elasticdl_tpu.common import codec as jcodec  # noqa: E402
from elasticdl_tpu.data.recordio_gen import tabular as jtabular  # noqa: E402
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JDispatcher  # noqa: E402
from elasticdl_tpu.models import deepfm_edl_embedding as jdeepfm  # noqa: E402
from elasticdl_tpu.models import deepfm_functional_api as jdeepfm_dense  # noqa: E402
from elasticdl_tpu.models import record_codec as jrc  # noqa: E402
from elasticdl_tpu.testing import InProcessMaster as JInProcessMaster  # noqa: E402
from elasticdl_tpu.testing import build_job as jbuild_job  # noqa: E402
from elasticdl_tpu.worker.worker import EmbeddingInput as JEmbeddingInput  # noqa: E402
from elasticdl_tpu.worker.worker import Worker as JWorker  # noqa: E402
from elasticdl_tpu_torch.api.layers import EmbeddingInput, prepare_batch_embedding  # noqa: E402
from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module  # noqa: E402
from elasticdl_tpu_torch.common import codec as tcodec  # noqa: E402
from elasticdl_tpu_torch.convert import load_variables  # noqa: E402
from elasticdl_tpu_torch.data.recordio_gen import tabular  # noqa: E402
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher  # noqa: E402
from elasticdl_tpu_torch.models import deepfm_edl_embedding as tdeepfm  # noqa: E402
from elasticdl_tpu_torch.models import deepfm_functional_api as tdeepfm_dense  # noqa: E402
from elasticdl_tpu_torch.models import record_codec as trc  # noqa: E402
from elasticdl_tpu_torch.testing import InProcessMaster, build_job  # noqa: E402
from elasticdl_tpu_torch.worker.worker import Worker  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401 (autouse fixture)

F32_REL = 1e-5
JOB_ATOL = 1e-5
RECORDS, VOCAB, BATCH, PER_TASK = 128, 60, 16, 64
FIELDS = tdeepfm.NUM_FIELDS


def _files(d):
    out = {}
    for root, _dirs, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def test_tabular_codec_and_synthetic_writer_are_the_references(tmp_path):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1 << 40, size=FIELDS)
    rec = trc.encode_tabular_record(ids, 1.0)
    assert rec == jrc.encode_tabular_record(ids, 1.0)
    got = trc.decode_tabular_records([rec, rec], FIELDS)
    want = jrc.decode_tabular_records([rec, rec], FIELDS)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    trc.write_synthetic_tabular_records(str(tmp_path / "p.rio"), 50, FIELDS, 1000, seed=3)
    jrc.write_synthetic_tabular_records(str(tmp_path / "r.rio"), 50, FIELDS, 1000, seed=3)
    assert (tmp_path / "p.rio").read_bytes() == (tmp_path / "r.rio").read_bytes()


@pytest.mark.parametrize("fmt", ["libfm", "csv"])
def test_tabular_cli_writes_the_references_shards(tmp_path, fmt):
    rng = np.random.default_rng(1)
    src = {}
    for split, n in (("train", 37), ("test", 11)):
        lines = []
        for _ in range(n):
            k = int(rng.integers(3, 8))
            feats = rng.choice(np.arange(100, 400), size=k, replace=False)
            if fmt == "libfm":
                lines.append(" ".join([str(int(rng.choice([-1, 1])))] + [f"{f}:1" for f in feats]))
            else:
                lines.append(",".join([str(f) for f in feats[:4]] + [str(int(rng.integers(2)))]))
        src[split] = tmp_path / f"{split}.{fmt}"
        src[split].write_text("\n".join(lines) + "\n")
    argv = ["--train", str(src["train"]), "--test", str(src["test"]), "--format", fmt,
            "--records_per_shard", "16"]
    assert tabular.main([str(tmp_path / "port")] + argv) == 0
    assert jtabular.main([str(tmp_path / "ref")] + argv) == 0
    got, want = _files(tmp_path / "port"), _files(tmp_path / "ref")
    assert sorted(got) == sorted(want) and len(got) == 3 + 1 + 1
    assert all(got[k] == want[k] for k in want)


def _batch(seed=4, b=BATCH, vocab=VOCAB):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(b, FIELDS))  # 0s: padding to mask
    labels = (rng.random(b) < 0.5).astype(np.float32)
    return {"ids": ids.astype(np.int32)}, labels


def _embs(features, specs, seed=5):
    rng = np.random.default_rng(seed)
    rows = {}

    def lookup(spec, uniq):
        return rng.uniform(-0.5, 0.5, (len(uniq), spec.dim)).astype(np.float32)

    for spec in specs:
        rows[spec.name] = prepare_batch_embedding(spec, features[spec.input_key], lookup)
    return rows


def _flax_init(jmod, features, embs=None):
    args = (features,) if embs is None else (features, {
        k: JEmbeddingInput(jnp.asarray(b.bet), jnp.asarray(b.inverse), jnp.asarray(b.mask))
        for k, b in embs.items()})
    v = jax.jit(lambda *a: jmod.custom_model().init(jax.random.PRNGKey(3), *a))(*args)
    return jax.tree_util.tree_map(np.asarray, v)["params"]


@pytest.mark.parametrize("name", ["edl", "dense"])
def test_init_has_flax_tree_and_distributions(name):
    features, _ = _batch()
    if name == "edl":
        embs = _embs(features, tdeepfm.embedding_specs)
        want = _flax_init(jdeepfm, features, embs)
        model = tdeepfm.custom_model()
    else:
        want = _flax_init(jdeepfm_dense, features)
        model = tdeepfm_dense.custom_model()
    params = model.init_params(9)
    assert tcodec.tree_paths(params) == [tuple(p) for p in tcodec.tree_paths(want)]
    assert [(a.shape, a.dtype) for a in tcodec.tree_leaves(params)] == [
        (np.asarray(a).shape, np.asarray(a).dtype) for a in tcodec.tree_leaves(want)]
    assert sorted(n for n, _ in model.named_parameters()) == sorted(
        ".".join(p) for p in tcodec.tree_paths(params))
    assert tcodec.ravel_np(model.init_params(9)).tobytes() == tcodec.ravel_np(params).tobytes()
    for path, leaf, ref in zip(tcodec.tree_paths(params), tcodec.tree_leaves(params),
                               tcodec.tree_leaves(want)):
        if path[-1] == "kernel":
            std = np.sqrt(1.0 / leaf.shape[0])
            assert np.abs(leaf).max() < 2 * std / 0.87962566103423978
            if leaf.size >= 2000:
                assert abs(leaf.std() / std - 1) < 0.1, path
        elif path[-1] == "embedding":
            std = np.sqrt(1.0 / leaf.shape[1])
            assert abs(leaf.std() / std - 1) < 0.05 and abs(np.asarray(ref).std() / std - 1) < 0.05
        else:  # biases: constants, flax's exactly
            assert leaf.tobytes() == np.asarray(ref).tobytes(), path


def _port_step(model, params, features, labels, embs=None):
    load_variables(model, params)
    x = {"ids": torch.from_numpy(features["ids"].astype(np.int64))}
    bets = {}
    if embs is not None:
        einp = {}
        for k, b in embs.items():
            bets[k] = torch.from_numpy(b.bet.copy()).requires_grad_(True)
            einp[k] = EmbeddingInput(bets[k], torch.from_numpy(b.inverse.astype(np.int64)),
                                     torch.from_numpy(b.mask))
        out = model(x, einp)
    else:
        out = model(x)
    loss = tdeepfm.loss(out, torch.from_numpy(labels))
    names = [".".join(p) for p in tcodec.tree_paths(params)]
    leaves = [model.get_parameter(n) for n in names] + list(bets.values())
    grads = torch.autograd.grad(loss, leaves)
    n = len(names)
    return (out.detach().numpy(), np.concatenate([g.reshape(-1).numpy() for g in grads[:n]]),
            {k: g.numpy() for k, g in zip(bets, grads[n:])})


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("name", ["edl", "dense"])
def test_forward_and_gradients_match_flax(name):
    features, labels = _batch()
    if name == "edl":
        jmod, model = jdeepfm, tdeepfm.custom_model()
        embs = _embs(features, tdeepfm.embedding_specs)
    else:
        jmod, model, embs = jdeepfm_dense, tdeepfm_dense.custom_model(), None
    params = model.init_params(2)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jbets = {k: jnp.asarray(b.bet) for k, b in (embs or {}).items()}

    def jloss(p, bets):
        args = (features,) if embs is None else (features, {
            k: JEmbeddingInput(bets[k], jnp.asarray(b.inverse), jnp.asarray(b.mask))
            for k, b in embs.items()})
        out = jmod.custom_model().apply({"params": p}, *args)
        return jmod.loss(out, jnp.asarray(labels)), out

    (_, jout), (jgp, jgb) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jparams, jbets)
    out, gp, gb = _port_step(model, params, features, labels, embs)
    assert _rel(out, np.asarray(jout)) <= F32_REL
    assert _rel(gp, jcodec.ravel_np(jgp)) <= F32_REL
    for k in gb:
        assert _rel(gb[k], np.asarray(jgb[k])) <= F32_REL, k
        # the padded rows of the bucket take no gradient
        assert not gb[k][len(embs[k].ids):].any()
    assert np.isfinite(float(optax.sigmoid_binary_cross_entropy(jout, labels).mean()))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("deepfm") / "tab.rio")
    trc.write_synthetic_tabular_records(path, RECORDS, FIELDS, VOCAB, seed=6)
    return path


def _ref_job(path, init, local_updates):
    dispatcher = JDispatcher({path: RECORDS}, {}, {}, PER_TASK, 1, shuffle_seed=2)
    spec = jspec_from_module(jdeepfm)
    servicer, _e, _c = jbuild_job(spec, dispatcher, grads_to_wait=1)
    servicer.report_variable({"params": init})
    kw = {"local_updates": local_updates, "sync_dtype": "float32", "overlap_sync": "off"} \
        if local_updates else {}
    worker = JWorker(0, JInProcessMaster(servicer), spec, minibatch_size=BATCH, **kw)
    assert worker.run()
    worker.close()
    return servicer


def _port_job(path, init, local_updates, overlap="off"):
    dispatcher = TaskDispatcher({path: RECORDS}, {}, {}, PER_TASK, 1, shuffle_seed=2)
    spec = spec_from_module(tdeepfm)
    servicer, _e, _c = build_job(spec, dispatcher, grads_to_wait=1, init_params=init)
    kw = {"local_updates": local_updates, "overlap_sync": overlap} if local_updates else {}
    worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=BATCH, device="cpu", **kw)
    assert worker.run()
    worker.close()
    assert dispatcher.finished()
    return servicer, worker


def _state(servicer):
    params, _aux, version = servicer.get_params_copy()
    return params, version, servicer._embedding_store.snapshot()


def _assert_close_jobs(got, want, exact_rows=False):
    gp, gv, gs = got
    wp, wv, ws = want
    assert gv == wv == RECORDS // BATCH
    np.testing.assert_allclose(tcodec.ravel_np(gp), jcodec.ravel_np(wp), atol=JOB_ATOL, rtol=0)
    assert sorted(gs) == sorted(ws)
    for layer in ws:
        assert sorted(gs[layer]) == sorted(ws[layer]), layer
        keys = sorted(ws[layer])
        np.testing.assert_allclose(np.stack([gs[layer][k] for k in keys]),
                                   np.stack([ws[layer][k] for k in keys]), atol=JOB_ATOL, rtol=0)


@pytest.mark.parametrize("local_updates", [0, 1, 4], ids=["per-step", "W1", "W4"])
def test_deepfm_job_matches_the_reference_job(records, local_updates):
    init = tdeepfm.custom_model().init_params(8)
    ref = _ref_job(records, init, local_updates)
    servicer, worker = _port_job(records, init, local_updates)
    got, want = _state(servicer), _state(ref)
    _assert_close_jobs(got, want)
    snap = got[2]
    assert {"fm_second", "fm_first", "fm_second/slot/m", "fm_second/slot/v"} <= set(snap)
    assert 0 not in snap["fm_second"]  # mask_zero: padding never learns
    assert servicer.exactness()["applied_update_steps"] == RECORDS // BATCH
    assert worker.lazy_init_rows == len(snap["fm_second"]) + len(snap["fm_first"])
    if local_updates == 1:
        per_step, _w = _port_job(records, init, 0)
        _assert_close_jobs(got, _state(per_step))


def test_deepfm_window_with_bet_prefetch_keeps_exactness(records, monkeypatch):
    init = tdeepfm.custom_model().init_params(8)
    monkeypatch.setenv("EDL_SYNC_DEPTH", "2")
    servicer, worker = _port_job(records, init, 4, overlap="on")
    assert worker._emb_prefetch_pool is not None  # the lookahead ran
    serial, _w = _port_job(records, init, 4)
    assert servicer.exactness() == serial.exactness() == {
        "version": RECORDS // BATCH, "init_version": 0, "applied_update_steps": RECORDS // BATCH}
    got, want = _state(servicer)[2], _state(serial)[2]
    assert {k: sorted(v) for k, v in got.items()} == {k: sorted(v) for k, v in want.items()}
    monkeypatch.setenv("EDL_BET_PREFETCH", "0")
    _s, off = _port_job(records, init, 4, overlap="on")
    assert off._emb_prefetch_pool is None


def test_convert_carries_a_reference_jobs_params_and_tables(records):
    """`variables_from_jax` and `embeddings_from_jax` carry a trained
    reference job's dense parameters and tables (rows and slots) into the
    port: a port store restored from them holds the same rows bit for
    bit, and the model with those parameters answers as the reference's."""
    from elasticdl_tpu_torch.convert import embeddings_from_jax, variables_from_jax
    from elasticdl_tpu_torch.master.embedding_store import NativeEmbeddingStore

    ref = _ref_job(records, tdeepfm.custom_model().init_params(8), 0)
    jparams, _aux, _v = ref.get_params_copy()
    snap = ref._embedding_store.snapshot()
    store = NativeEmbeddingStore()
    store.restore(embeddings_from_jax(snap))
    assert _tables_bytes(store.snapshot()) == _tables_bytes(snap)
    params, aux = variables_from_jax({"params": jparams})
    assert not aux
    features, labels = _batch(seed=7)
    embs = _embs(features, tdeepfm.embedding_specs)
    out, _gp, _gb = _port_step(tdeepfm.custom_model(), params, features, labels, embs)
    jout = jdeepfm.custom_model().apply({"params": jax.tree_util.tree_map(jnp.asarray, jparams)},
                                        features, {k: JEmbeddingInput(jnp.asarray(b.bet),
                                                                      jnp.asarray(b.inverse),
                                                                      jnp.asarray(b.mask))
                                                   for k, b in embs.items()})
    assert _rel(out, np.asarray(jout)) <= F32_REL


def _tables_bytes(snap):
    return {layer: {int(i): np.asarray(r).tobytes() for i, r in rows.items()}
            for layer, rows in snap.items()}
