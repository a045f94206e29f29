"""The port's KV shards against the reference's, on the CPU.

- The snapshot's wire form ({layer: {ids, values}}) round-trips, and
  equals the reference's `snapshot_to_arrays`.
- `ShardedEmbeddingStore` over 3 inproc shards and 2 shard processes
  answers every lookup as one in-process store fed the same updates
  (bit for bit, the unknown positions in the caller's order), keeps one
  SETNX winner among racing threads, and snapshots and restores across
  shard counts.
- The sparse optimizer (Adam) through the shards leaves the rows and
  slots that the reference's optimizer leaves on its own in-process
  store, bit for bit.
- A deepfm_edl_embedding job through `master.main` with 2 KV shard
  processes and 2 CPU worker processes, window mode: the workers look
  rows up from the shards (the master answers no EmbeddingLookup), the
  exactness block holds, the shards hold one row per distinct non-zero
  id seen (and the Adam slots), an evaluation reports an AUC, and the
  `--output` file carries the tables. (A group's `stop` leaves no shard
  process: the `group` fixture holds it.)
- A checkpoint with embeddings written by either package boots the
  other's job: the dense parameters and every table row come back bit
  for bit.
"""

import os
import threading

import numpy as np
import pytest

from elasticdl_tpu.api.model_spec_helpers import spec_from_module as jspec_from_module
from elasticdl_tpu.common import codec as jcodec
from elasticdl_tpu.master import embedding_store as jstore
from elasticdl_tpu.master import kv_shard as jkv_shard
from elasticdl_tpu.master import sparse_optimizer as jsparse
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JDispatcher
from elasticdl_tpu.models import deepfm_edl_embedding as jdeepfm
from elasticdl_tpu.testing import InProcessMaster as JInProcessMaster
from elasticdl_tpu.testing import build_job as jbuild_job
from elasticdl_tpu.worker.worker import Worker as JWorker
from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module
from elasticdl_tpu_torch.common import codec as tcodec
from elasticdl_tpu_torch.common.constants import ENV_WORKER_LOG_DIR
from elasticdl_tpu_torch.master import main as master_main
from elasticdl_tpu_torch.master.embedding_store import NativeEmbeddingStore
from elasticdl_tpu_torch.master.kv_group import KVShardGroup
from elasticdl_tpu_torch.master.kv_shard import arrays_to_snapshot, snapshot_to_arrays
from elasticdl_tpu_torch.master.sparse_optimizer import SparseOptimizer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models import deepfm_edl_embedding as tdeepfm
from elasticdl_tpu_torch.models.record_codec import write_synthetic_tabular_records
from elasticdl_tpu_torch.rpc.kv_client import ShardedEmbeddingStore
from elasticdl_tpu_torch.testing import InProcessMaster, build_job
from elasticdl_tpu_torch.worker.main import read_summaries
from elasticdl_tpu_torch.worker.worker import Worker
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(REPO, "elasticdl_tpu_torch", "models")
FIELDS = tdeepfm.NUM_FIELDS


def test_snapshot_wire_roundtrip_is_the_references():
    snap = {"t": {1: np.arange(4, dtype=np.float32), 9: np.ones(4, np.float32)}, "empty": {}}
    wire = snapshot_to_arrays(snap)
    want = jkv_shard.snapshot_to_arrays(snap)
    assert sorted(wire) == sorted(want) == ["t"]
    for k in ("ids", "values"):
        assert wire["t"][k].tobytes() == want["t"][k].tobytes()
    back = arrays_to_snapshot(tcodec.loads(tcodec.dumps(wire)))
    assert set(back["t"]) == {1, 9}
    np.testing.assert_array_equal(back["t"][1], snap["t"][1])


@pytest.fixture(params=[("inproc", 3), ("process", 2)], ids=["inproc3", "process2"])
def group(request):
    mode, n = request.param
    g = KVShardGroup(n, mode=mode, boot_timeout=120)
    g.start()
    yield g
    procs = list(g.procs)
    g.stop()
    assert all(p.poll() is not None for p in procs)
    assert not g.endpoints


def test_sharded_store_answers_as_one_store(group):
    store = group.store()
    local = NativeEmbeddingStore()
    rng = np.random.default_rng(0)
    vals, unknown = store.lookup("t", np.array([5, 0, 301]))
    assert vals.shape == (3, 0) and unknown.tolist() == [0, 1, 2]
    for step in range(12):
        ids = rng.integers(0, 400, size=int(rng.integers(1, 20)))
        if step % 3 == 2:
            for got, want in zip(store.lookup("t", ids), local.lookup("t", ids)):
                assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
            continue
        v = rng.standard_normal((len(ids), 4)).astype(np.float32)
        uniq = np.unique(ids, return_index=True)[1]  # one write an id: a call's order is per shard
        store.update("t", ids[uniq], v[uniq], set_if_not_exist=bool(step % 2))
        local.update("t", ids[uniq], v[uniq], set_if_not_exist=bool(step % 2))
    assert len(store) == len(local)
    assert sum(s["n"] for s in store.shard_lens()) == len(local)
    assert all(s["store"] == "NativeEmbeddingStore" for s in store.shard_lens())
    snap = store.snapshot()
    want = local.snapshot()
    assert {i: r.tobytes() for i, r in snap["t"].items()} == {
        i: r.tobytes() for i, r in want["t"].items()}
    # restore across shard counts: into one in-process store and back
    other = NativeEmbeddingStore()
    other.restore(snap)
    assert len(other) == len(local)
    store.restore({"u": {7: np.ones(2, np.float32), 8: np.zeros(2, np.float32)}})
    vals, unknown = store.lookup("u", [8, 7])
    assert unknown.size == 0 and vals.tolist() == [[0, 0], [1, 1]]


def test_sharded_store_setnx_has_one_winner():
    g = KVShardGroup(2, mode="inproc")
    g.start()
    try:
        store = g.store()
        ids = np.arange(40)
        fills = [float(t + 1) for t in range(6)]
        barrier = threading.Barrier(len(fills))

        def racer(fill):
            barrier.wait()
            store.update("e", ids, np.full((40, 3), fill, np.float32), set_if_not_exist=True)

        threads = [threading.Thread(target=racer, args=(f,)) for f in fills]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        vals, unknown = store.lookup("e", ids)
        assert unknown.size == 0
        for row in vals:
            assert row[0] in fills and (row == row[0]).all()
    finally:
        g.stop()


def test_sparse_optimizer_through_the_shards_is_the_references():
    g = KVShardGroup(2, mode="inproc")
    g.start()
    try:
        store, ref_store = g.store(), jstore.PyEmbeddingStore()
        opt = SparseOptimizer(store, kind="adam", learning_rate=0.1)
        ref = jsparse.SparseOptimizer(ref_store, kind="adam", learning_rate=0.1)
        rng = np.random.default_rng(1)
        ids = np.arange(1, 11, dtype=np.int64)
        init = rng.uniform(-0.05, 0.05, (10, 4)).astype(np.float32)
        store.update("t", ids, init)
        ref_store.update("t", ids, init)
        for _ in range(3):
            idx = rng.choice(ids, size=14)
            v = rng.standard_normal((14, 4)).astype(np.float32)
            opt.apply_gradients({"t": tcodec.IndexedRows(v, idx)})
            ref.apply_gradients({"t": jcodec.IndexedRows(v, idx)})
        got, want = store.snapshot(), ref_store.snapshot()
        assert sorted(got) == sorted(want) == ["t", "t/slot/m", "t/slot/v"]
        for layer in want:
            assert {i: r.tobytes() for i, r in got[layer].items()} == {
                i: r.tobytes() for i, r in want[layer].items()}, layer
        values, _ = store.lookup("t", ids)
        assert not np.array_equal(values, init)
    finally:
        g.stop()


def test_deepfm_process_job_over_kv_shard_processes(tmp_path, monkeypatch):
    train, evals = tmp_path / "train", tmp_path / "eval"
    train.mkdir()
    evals.mkdir()
    for i in range(2):
        write_synthetic_tabular_records(str(train / f"s{i}.rio"), 64, FIELDS, 5000, seed=i)
    write_synthetic_tabular_records(str(evals / "e.rio"), 32, FIELDS, 5000, seed=9)
    monkeypatch.setenv(ENV_WORKER_LOG_DIR, str(tmp_path / "logs"))
    output = str(tmp_path / "final.ckpt")
    rc, summary = master_main.run([
        "--model_zoo", ZOO, "--model_def", "deepfm_edl_embedding.custom_model",
        "--minibatch_size", "16", "--records_per_task", "32", "--device", "cpu",
        "--envs", "OMP_NUM_THREADS=1", "--training_data_dir", str(train),
        "--evaluation_data_dir", str(evals), "--eval_steps", "8", "--num_workers", "2",
        "--local_updates", "2", "--num_kv_shards", "2", "--kv_mode", "process",
        "--grads_to_wait", "1", "--output", output,
    ])
    assert rc == 0
    steps = 128 // 16
    assert {k: summary[k] for k in ("version", "init_version", "applied_update_steps")} == {
        "version": steps, "init_version": 0, "applied_update_steps": steps}
    assert summary["server"]["calls"].get("EmbeddingLookup", 0) == 0
    assert summary["server"]["calls"].get("EmbeddingUpdate", 0) == 0
    sparse = summary["sparse"]
    assert sparse["store"] == ["NativeEmbeddingStore"] * 2
    workers = read_summaries(str(tmp_path / "logs"))
    assert len(workers) == 2
    assert all(s["kv_tiers"] == ["tcp", "tcp"] for s in workers.values())
    assert sum(s["edl_gradient_bytes"] for s in workers.values()) > 0
    # each table: one row per distinct non-zero id seen (evaluation
    # lookups init rows too), and two Adam slot rows per id trained on
    from elasticdl_tpu_torch.data.recordio import RecordIOReader
    from elasticdl_tpu_torch.models.record_codec import decode_tabular_records

    seen, trained = set(), set()
    for path in [*train.iterdir(), *evals.iterdir()]:
        with RecordIOReader(str(path)) as r:
            ids, _ = decode_tabular_records(list(r.read_range(0, 64)), FIELDS)
        seen |= set(ids[ids != 0].tolist())
        if path.parent == train:
            trained |= set(ids[ids != 0].tolist())
    assert sum(sparse["rows"]) == 2 * len(seen) + 2 * 2 * len(trained)
    assert sum(s["lazy_init_rows"] for s in workers.values()) >= 2 * len(seen)
    (version, metrics), = summary["evaluations"]
    assert 0.0 <= metrics["auc"] <= 1.0 and 0.0 <= metrics["accuracy"] <= 1.0
    from elasticdl_tpu_torch.master.checkpoint import load_model_file

    final = load_model_file(output)
    assert final.version == steps
    assert len(final.embeddings["fm_second"]) == len(seen)


def _port_ckpt_job(path, n, ckpt_dir="", init="", epochs=1):
    dispatcher = TaskDispatcher({path: n}, {}, {}, n, epochs, shuffle_seed=1)
    spec = spec_from_module(tdeepfm)
    servicer, _e, ckpt = build_job(spec, dispatcher, 1, checkpoint_dir=ckpt_dir,
                                   checkpoint_steps=n // 8 if ckpt_dir else 0,
                                   checkpoint_filename_for_init=init)
    return servicer, dispatcher, spec, ckpt


def _ref_ckpt_job(path, n, ckpt_dir="", init=""):
    dispatcher = JDispatcher({path: n}, {}, {}, n, 1, shuffle_seed=1)
    spec = jspec_from_module(jdeepfm)
    servicer, _e, ckpt = jbuild_job(spec, dispatcher, 1, checkpoint_dir=ckpt_dir,
                                    checkpoint_steps=n // 8 if ckpt_dir else 0,
                                    checkpoint_filename_for_init=init)
    return servicer, dispatcher, spec, ckpt


def _tables(snap):
    return {layer: {i: r.tobytes() for i, r in rows.items()} for layer, rows in snap.items()}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_with_embeddings_boots_the_other_package(tmp_path, writer):
    path = str(tmp_path / "tab.rio")
    write_synthetic_tabular_records(path, 32, FIELDS, 200, seed=3)
    ckpt_dir = str(tmp_path / "ckpt")
    if writer == "port":
        servicer, _d, spec, ckpt = _port_ckpt_job(path, 32, ckpt_dir)
        worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=8, device="cpu")
    else:
        servicer, _d, spec, ckpt = _ref_ckpt_job(path, 32, ckpt_dir)
        worker = JWorker(0, JInProcessMaster(servicer), spec, minibatch_size=8)
    assert worker.run()
    worker.close()
    ckpt_path = ckpt.latest_path()
    assert ckpt_path and ckpt_path.endswith("model_v4.ckpt")
    params, _aux, version = servicer.get_params_copy()
    tables = _tables(servicer._embedding_store.snapshot())
    assert {"fm_second", "fm_second/slot/m", "fm_first/slot/v"} <= set(tables)
    boot = (_ref_ckpt_job if writer == "port" else _port_ckpt_job)(path, 32, init=ckpt_path)[0]
    bparams, _baux, bversion = boot.get_params_copy()
    assert bversion == version == 4
    assert tcodec.ravel_np(bparams).tobytes() == jcodec.ravel_np(params).tobytes()
    assert _tables(boot._embedding_store.snapshot()) == tables
