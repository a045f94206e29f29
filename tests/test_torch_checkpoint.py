"""Checkpoints and exact resume in the port against the reference.

- The checkpoint service's cadence (floor crossing), background writer,
  flush and rotation leave the same files as the reference's.
- A checkpoint the reference writes boots the port (params, aux,
  version, optimizer state, equal), a port checkpoint boots the
  reference, and after the same further reports the two PSs agree
  within `OPT` (1e-6: optax under XLA against the same formulas in
  torch).
- The port's own resume (one worker, one task an epoch, the reference's
  protocol, `tests/test_exact_resume.py`) ends BIT-equal to the
  uninterrupted run; a resume from the same file with `opt_state`
  stripped does not.
- master.main on the CPU: 2 async worker processes with evaluation
  during training, checkpoints and the metrics sink; then a standalone
  evaluation job from the checkpoint it left.
"""

import json
import logging
import os

import numpy as np
import pytest

from elasticdl_tpu.api.model_spec_helpers import spec_from_module as jspec_from_module
from elasticdl_tpu.common import codec as jcodec
from elasticdl_tpu.master.checkpoint import CheckpointService as JCheckpointService
from elasticdl_tpu.master.checkpoint import load_model_file as jload_model_file
from elasticdl_tpu.models import transformer_lm_zoo as jzoo
from elasticdl_tpu.testing import build_job as jbuild_job
from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module
from elasticdl_tpu_torch.common import codec
from elasticdl_tpu_torch.common.args import master_parser
from elasticdl_tpu_torch.common.constants import ENV_TB_BACKEND, ENV_WORKER_LOG_DIR
from elasticdl_tpu_torch.master import main as master_main
from elasticdl_tpu_torch.master.checkpoint import (
    CheckpointService,
    load_model_file,
    save_model_file,
)
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models import transformer_lm_zoo as tzoo
from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
from elasticdl_tpu_torch.testing import InProcessMaster, build_job
from elasticdl_tpu_torch.worker.main import read_summaries
from elasticdl_tpu_torch.worker.worker import Worker
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

OPT = dict(atol=1e-6, rtol=1e-6)
TINY = dict(vocab=16, d_model=16, n_heads=2, d_ff=32, n_layers=1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(REPO, "elasticdl_tpu_torch", "models")


def _files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".ckpt"))


def test_rotation_and_the_writer_equal_the_references(tmp_path):
    pairs = [JCheckpointService(str(tmp_path / "ref"), 3, 2),
             CheckpointService(str(tmp_path / "port"), 3, 2)]
    grid = [(p, v) for p in range(0, 12) for v in range(p, 14)]
    assert [pairs[1].crossed(p, v) for p, v in grid] == [pairs[0].crossed(p, v) for p, v in grid]
    params = {"w": np.arange(4, dtype=np.float32)}
    for svc in pairs:
        # cadence points as a servicer meets them: single steps and one
        # multi-step bump that jumps over 9 (saved at its post-bump 10)
        prev = 0
        for v in (1, 2, 3, 4, 5, 6, 7, 10, 11, 12):
            if svc.crossed(prev, v):
                svc.save({"w": params["w"] + v}, v, aux={"s": np.ones(2, np.float32) * v},
                         opt_state={"kind": "single", "leaves": [np.int32(v)]})
            prev = v
        svc.flush()
        svc.save(params, 5, is_eval=True)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref") == [
        "model_v10.ckpt", "model_v12.ckpt"]
    ref, port = pairs
    assert os.path.basename(port.latest_path()) == os.path.basename(ref.latest_path())
    for svc in pairs:
        m = svc.load_version(10)
        assert m.version == 10 and np.array_equal(m.params["w"], params["w"] + 10)
        assert svc.load_version(6) is None  # rotated away
        assert svc.get_eval_model(5).version == 5
        svc.remove_eval_checkpoint(5)
        assert svc.get_eval_model(5) is None
        svc.close()
        # a closed service still saves: the writer restarts
        svc.save(params, 15)
        svc.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "ref") == [
        "model_v12.ckpt", "model_v15.ckpt"]


def test_the_checkpoint_frame_is_the_references_byte_for_byte():
    """`codec.dumps_v2` writes the reference's `codec.dumps` frame bit
    for bit (msgpack header included), and each package's loader reads
    the other's."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    payload = {
        "version": 70000, "params": {"a": f32, "b": {"c": np.arange(5, dtype=np.int32)}},
        "aux": None, "opt_state": {"kind": "single", "leaves": [np.zeros((), np.int32), f32]},
        "misc": [1, -1, -33, 200, -40000, 2 ** 40, 1.5, "s" * 40, "t" * 300, True, (1, 2)],
        # each msgpack size class's edges: ints, strings, arrays, maps
        "ints": [127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 64 - 1, -32, -129, -32769,
                 -(2 ** 31) - 1, -(2 ** 63)],
        "strs": ["s" * 31, "s" * 32, "s" * 255, "s" * 256, "s" * 70000],
        "list16": list(range(16)), "map16": {str(i): i for i in range(16)},
    }
    ref = jcodec.dumps(payload)
    assert codec.dumps_v2(payload) == ref
    back = codec.loads(ref)
    for k in ("misc", "ints", "strs", "list16", "map16"):
        assert back[k] == payload[k], k
    assert back["aux"] is None
    assert back["params"]["a"].tobytes() == f32.tobytes()
    assert back["opt_state"]["leaves"][0].dtype == np.int32
    bf16 = codec.BF16Bits.from_f32(f32)
    got = jcodec.loads(codec.dumps_v2({"w": bf16}))["w"]
    assert got.dtype == ml_dtypes.bfloat16 and got.view(np.uint16).tobytes() == bf16.bits.tobytes()
    assert codec.loads(jcodec.dumps({"w": got}))["w"].bits.tobytes() == bf16.bits.tobytes()


def _specs():
    return (jspec_from_module(jzoo, model=jzoo.custom_model(**TINY)),
            spec_from_module(tzoo, model=tzoo.custom_model(**TINY)))


def _reports(servicer, n, start, flat_size):
    for i in range(n):
        rng = np.random.default_rng(50 + start + i)
        servicer.report_gradient({
            "worker_id": 0, "version": servicer.version,
            "gradient_flat": (rng.standard_normal(flat_size) * 0.1).astype(np.float32),
            "aux_state": {"batch_stats": {"m": np.full(3, start + i, np.float32)}},
        })


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_checkpoint_boots_the_other_package(tmp_path, writer):
    jspec, tspec = _specs()
    init = tzoo.custom_model(**TINY).init_params(0)
    n = codec.ravel_np(init).size
    path = str(tmp_path / "mid.ckpt")
    if writer == "reference":
        src, _e, _c = jbuild_job(jspec, None)
    else:
        src, _e, _c = build_job(tspec, None)
    src.report_variable({"params": init})
    _reports(src, 3, 0, n)
    src.save_latest_checkpoint(path)

    # either package's loader reads the file the same
    jm, tm = jload_model_file(path), load_model_file(path)
    assert tm.version == jm.version == 3
    assert codec.ravel_np(tm.params).tobytes() == jcodec.ravel_np(jm.params).tobytes()
    assert np.array_equal(tm.aux["batch_stats"]["m"], jm.aux["batch_stats"]["m"])
    assert tm.opt_state["kind"] == jm.opt_state["kind"] == "single"
    # clip + Adam: count, then mu and nu for each leaf
    n_leaves = len(codec.tree_leaves(init))
    assert len(tm.opt_state["leaves"]) == len(jm.opt_state["leaves"]) == 1 + 2 * n_leaves
    for a, b in zip(tm.opt_state["leaves"], jm.opt_state["leaves"]):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()

    ref, _e, _c = jbuild_job(jspec, None, checkpoint_filename_for_init=path)
    port, _e, _c = build_job(tspec, None, checkpoint_filename_for_init=path)
    assert port.exactness() == {"version": 3, "init_version": 3, "applied_update_steps": 0}
    assert ref.version == 3
    assert [a.tobytes() for a in port._opt.state_snapshot()] == [
        np.asarray(a).tobytes() for a in jm.opt_state["leaves"]]
    _reports(ref, 4, 3, n)
    _reports(port, 4, 3, n)
    (jp, jaux, jv), (tp, taux, tv) = ref.get_params_copy(), port.get_params_copy()
    assert tv == jv == 7
    np.testing.assert_allclose(codec.ravel_np(tp), jcodec.ravel_np(jp), **OPT)
    assert np.array_equal(taux["batch_stats"]["m"], jaux["batch_stats"]["m"])
    assert port.exactness() == {"version": 7, "init_version": 3, "applied_update_steps": 4}


def test_build_master_boots_from_the_checkpoint_flag(tmp_path):
    _jspec, tspec = _specs()
    src, _e, _c = build_job(tspec, None)
    src.report_variable({"params": tspec.model.init_params(0)})
    _reports(src, 2, 0, codec.ravel_np(tspec.model.init_params(0)).size)
    path = str(tmp_path / "boot.ckpt")
    src.save_latest_checkpoint(path)
    data = tmp_path / "data"
    data.mkdir()
    write_learnable_token_records(str(data / "t.rio"), 8, 16, TINY["vocab"], seed=0)
    args = master_parser().parse_args([
        "--model_zoo", ZOO, "--model_def", "transformer_lm_zoo.custom_model",
        "--model_params", ",".join(f"{k}={v}" for k, v in TINY.items()),
        "--minibatch_size", "4", "--training_data_dir", str(data),
        "--checkpoint_filename_for_init", path, "--device", "cpu",
    ])
    _spec, _d, servicer, evs, ckpt = master_main.build_master(args)
    assert evs is None and servicer.tb_service is None
    assert servicer.exactness() == {"version": 2, "init_version": 2, "applied_update_steps": 0}
    want = src._opt.state_snapshot()
    assert [a.tobytes() for a in servicer._opt.state_snapshot()] == [a.tobytes() for a in want]
    ckpt.close()


N, MB = 32, 8


def _run(path, epochs, ckpt_init=""):
    """The reference's protocol: one worker, one task an epoch (the batch
    order is the read order in every epoch), grads_to_wait 1."""
    dispatcher = TaskDispatcher({path: N}, {}, {}, N, epochs)
    spec = spec_from_module(tzoo, model=tzoo.custom_model(**TINY))
    servicer, _evs, _ckpt = build_job(spec, dispatcher, checkpoint_filename_for_init=ckpt_init)
    worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=MB, device="cpu")
    assert worker.run()
    worker.close()
    assert dispatcher.finished()
    params, _aux, version = servicer.get_params_copy()
    return servicer, codec.ravel_np(params), version


def test_resume_is_bit_exact_and_the_stripped_control_diverges(tmp_path):
    path = str(tmp_path / "train.rio")
    write_learnable_token_records(path, N, 16, TINY["vocab"], seed=0)
    _s, full, full_v = _run(path, 4)
    first, _vec, v1 = _run(path, 2)
    ckpt = str(tmp_path / "mid.ckpt")
    first.save_latest_checkpoint(ckpt)
    resumed_s, resumed, resumed_v = _run(path, 2, ckpt_init=ckpt)
    assert resumed_v == full_v == 2 * v1 == 4 * N // MB
    assert resumed_s.exactness() == {"version": full_v, "init_version": v1,
                                     "applied_update_steps": v1}
    np.testing.assert_array_equal(resumed, full)  # BIT-equal
    m = load_model_file(ckpt)
    stripped = str(tmp_path / "stripped.ckpt")
    save_model_file(stripped, m.params, m.version, aux=m.aux)
    _s2, cold, _cv = _run(path, 2, ckpt_init=stripped)
    assert np.max(np.abs(cold - full)) > 1e-4


def _token_dir(path, n_files, records, seed):
    os.makedirs(path)
    for i in range(n_files):
        write_learnable_token_records(os.path.join(path, f"shard-{i}.rio"), records, 16,
                                      TINY["vocab"], seed=seed + i)
    return str(path)


@pytest.fixture
def _root_log_level():
    level = logging.getLogger().level
    yield
    logging.getLogger().setLevel(level)


def test_async_process_job_with_evaluation_and_checkpoints(tmp_path, monkeypatch,
                                                           _root_log_level):
    """master.main with 2 async worker processes on the CPU: every report
    applied once, evaluation jobs over all 12 records at versions past
    their cadence points, the train loss and eval rows in events.jsonl,
    the rotated checkpoints with the optimizer's state, no eval snapshot
    left; then a standalone evaluation job from the last checkpoint
    scores it as the in-process evaluation service does."""
    train = _token_dir(tmp_path / "train", 2, 16, 0)
    evals = _token_dir(tmp_path / "eval", 1, 12, 7)
    ckpt_dir, tb = str(tmp_path / "ckpt"), str(tmp_path / "tb")
    output = str(tmp_path / "final.ckpt")
    monkeypatch.setenv(ENV_WORKER_LOG_DIR, str(tmp_path / "logs"))
    monkeypatch.setenv(ENV_TB_BACKEND, "jsonl")
    spec_argv = ["--model_zoo", ZOO, "--model_def", "transformer_lm_zoo.custom_model",
                 "--model_params", ",".join(f"{k}={v}" for k, v in TINY.items()),
                 "--minibatch_size", "4", "--records_per_task", "8", "--device", "cpu",
                 "--worker_backend", "process", "--envs", "OMP_NUM_THREADS=1"]
    rc, summary = master_main.run(spec_argv + [
        "--training_data_dir", train, "--evaluation_data_dir", evals, "--num_workers", "2",
        "--use_async", "--lr_staleness_modulation", "--eval_steps", "4",
        "--checkpoint_dir", ckpt_dir, "--checkpoint_steps", "2", "--keep_checkpoint_max", "2",
        "--tensorboard_log_dir", tb, "--output", output,
    ])
    assert rc == 0
    steps = 2 * 16 // 4
    assert summary["job_type"] == "training_with_evaluation"
    assert {k: summary[k] for k in ("version", "init_version", "applied_update_steps")} == {
        "version": steps, "init_version": 0, "applied_update_steps": steps}
    workers = read_summaries(str(tmp_path / "logs"))
    assert sum(s["steps_accepted"] for s in workers.values()) == steps
    assert all(s["steps_computed"] == s["steps_accepted"] for s in workers.values())
    evaluations = summary["evaluations"]
    assert evaluations and sum(s["eval_tasks"] for s in workers.values()) == 2 * len(evaluations)
    versions = [v for v, _m in evaluations]
    assert versions == sorted(set(versions)) and versions[0] >= 4
    for _v, m in evaluations:
        assert set(m) == {"cross_entropy", "accuracy", "perplexity"}
        assert 0 <= m["accuracy"] <= 1 and np.isfinite(m["cross_entropy"])
    with open(os.path.join(tb, "events.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert sorted(r["step"] for r in rows if r["tag"] == "train/loss") == list(range(1, steps + 1))
    assert [(r["step"], r["value"]) for r in rows if r["tag"] == "eval/accuracy"] == [
        (v, m["accuracy"]) for v, m in evaluations]
    assert _files(ckpt_dir) == ["model_v6.ckpt", "model_v8.ckpt"]
    for v in (6, 8):
        m = load_model_file(os.path.join(ckpt_dir, f"model_v{v}.ckpt"))
        assert m.version == v and m.opt_state["kind"] == "single"
        assert len(m.opt_state["leaves"]) == 1 + 2 * len(codec.tree_leaves(m.params))
    final = load_model_file(output)
    assert final.version == steps
    np.testing.assert_array_equal(
        codec.ravel_np(final.params),
        codec.ravel_np(load_model_file(os.path.join(ckpt_dir, "model_v8.ckpt")).params))

    # the standalone evaluation of the v8 checkpoint
    rc, summary = master_main.run(spec_argv + [
        "--evaluation_data_dir", evals, "--num_workers", "1",
        "--checkpoint_filename_for_init", os.path.join(ckpt_dir, "model_v8.ckpt"),
    ])
    assert rc == 0 and summary["job_type"] == "evaluation"
    assert [v for v, _m in summary["evaluations"]] == [8]
    # the same records through the port's in-process evaluation path
    dispatcher = TaskDispatcher({}, {os.path.join(evals, "shard-0.rio"): 12}, {}, 8, 1,
                                eval_model_version=8)
    spec = spec_from_module(tzoo, model=tzoo.custom_model(**TINY))
    servicer, _e, ckpt = build_job(
        spec, dispatcher, checkpoint_filename_for_init=os.path.join(ckpt_dir, "model_v8.ckpt"))
    evs = EvaluationService(ckpt, dispatcher, current_model_fn=servicer.get_params_copy)
    dispatcher.set_evaluation_service(evs)
    servicer.set_evaluation_service(evs)
    evs.start_standalone_job(servicer.version, 2)
    worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=4, device="cpu")
    assert worker.run()
    (_v, want), = evs.completed_metrics
    got = summary["evaluations"][0][1]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
