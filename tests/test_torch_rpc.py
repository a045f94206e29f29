"""The port's RPC plane and command line against the reference.

Every method the port serves returns the same response through a real
socket (`RpcServer` / `RpcClient`) as through `InProcessMaster` for the
same servicer state, float32 and bfloat16-bit arrays bit for bit; the
transport's failures carry the reference's status codes; the retry
schedule, the idempotent set, the flag defaults, the job-type check and
the shard count equal the reference's on the same inputs.
"""

import socket
import threading
import time

import grpc
import numpy as np
import pytest

from elasticdl_tpu.common import args as jargs
from elasticdl_tpu.common.constants import GRPC_MAX_MESSAGE_LENGTH
from elasticdl_tpu.master.main import collect_shards as jcollect_shards
from elasticdl_tpu.rpc import policy as jpolicy
from elasticdl_tpu_torch.common import args as targs
from elasticdl_tpu_torch.common.codec import BF16Bits, SparseDelta, quantize_int8
from elasticdl_tpu_torch.master.embedding_store import EmbeddingStore
from elasticdl_tpu_torch.master.kv_shard import KVShardServicer
from elasticdl_tpu_torch.master.main import collect_shards
from elasticdl_tpu_torch.master.ps_optimizer import PSOptimizer
from elasticdl_tpu_torch.master.ps_shard import PSShardServicer
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models import transformer_lm_zoo as tzoo
from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
from elasticdl_tpu_torch.rpc import policy, transport
from elasticdl_tpu_torch.rpc.client import RpcClient
from elasticdl_tpu_torch.rpc.policy import PolicyRpcError, RetryPolicy, StatusCode
from elasticdl_tpu_torch.rpc.server import RpcServer
from elasticdl_tpu_torch.testing import InProcessMaster
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

SPEC_ARGV = ["--model_zoo", "zoo", "--model_def", "m.custom_model", "--minibatch_size", "8"]


def _servicer():
    dispatcher = TaskDispatcher({"shard-a": 64, "shard-b": 40}, {}, {}, 32, 1, shuffle_seed=5)
    return MasterServicer(
        grads_to_wait=1, optimizer=PSOptimizer(tzoo.optimizer()), task_dispatcher=dispatcher,
        embedding_store=EmbeddingStore(),
    )


def _calls():
    """A call sequence over every ported method: lazy init (an f32 tree
    with a bf16 aux), pulls, an accepted f32 gradient, a stale bf16 one,
    an accepted bf16 one, window syncs, a sharded push's metadata, task
    reports (one failed), an embedding row write (SETNX), a lookup with a
    miss, and a worker's restore upload with no recovery plane (refused)."""
    rng = np.random.default_rng(0)
    params = {
        "dense": {
            "kernel": rng.standard_normal((8, 4)).astype(np.float32),
            "bias": rng.standard_normal(4).astype(np.float32),
        }
    }
    aux = {"stats": BF16Bits.from_f32(rng.standard_normal(6).astype(np.float32))}
    grad = rng.standard_normal(36).astype(np.float32)
    return [
        ("GetPSConfig", {}),
        ("GetTask", {"worker_id": 0}),
        ("GetModel", {"version": -1, "method": "minimum", "only_if_newer": True}),
        ("ReportVariable", {"params": params, "aux": aux}),
        ("GetModel", {"version": -1, "method": "minimum", "only_if_newer": True}),
        ("GetModel", {"version": -1, "method": "minimum", "flat": True}),
        ("GetAux", {}),
        ("ReportGradient", {"worker_id": 0, "version": 0, "gradient_flat": grad,
                            "loss": 1.5, "return_model": True}),
        ("ReportGradient", {"worker_id": 0, "version": 0,
                            "gradient_flat": BF16Bits.from_f32(grad * 2),
                            "loss": 1.25, "return_model": True}),
        ("ReportGradient", {"worker_id": 0, "version": 1,
                            "gradient_flat": BF16Bits.from_f32(grad * 3),
                            "loss": 1.0, "return_model": True}),
        ("GetModel", {"version": 1, "method": "minimum", "only_if_newer": True}),
        # the exact live version, and one evaluation minibatch's metrics
        ("GetModel", {"version": 2, "method": "fixed", "flat": True}),
        ("ReportEvaluationMetrics", {"model_version": 2, "metrics": {"accuracy": 0.5},
                                     "num_examples": 4}),
        # window syncs: an int8 delta that lands unmerged, a top-k delta
        # whose base fell behind (merged model back in bf16), its resend
        ("ReportLocalUpdate", {"delta_flat": quantize_int8(grad * 1e-3), "steps": 2,
                               "base_version": 2, "report_key": "w0.0", "aux_state": None}),
        ("ReportLocalUpdate", {"delta_flat": SparseDelta(np.arange(0, 36, 5, dtype=np.int32),
                                                         grad[::5] * 1e-3, 36),
                               "steps": 1, "base_version": 0, "report_key": "w1.0",
                               "aux_state": None, "model_dtype": "bfloat16"}),
        ("ReportLocalUpdate", {"delta_flat": grad * 1e-3, "steps": 1, "base_version": 0,
                               "report_key": "w1.0", "aux_state": None,
                               "model_dtype": "bfloat16"}),
        # a sharded push's metadata at the current version (no advance),
        # asking for the aux back
        ("ReportWindowMeta", {"worker_id": 0, "versions": [5, 5], "loss": 0.75,
                              "want_aux": True}),
        ("ReportTaskResult", {"task_id": 1, "err_message": "", "worker_id": 0}),
        ("GetTask", {"worker_id": 0}),
        ("ReportTaskResult", {"task_id": 2, "err_message": "boom", "worker_id": 0}),
        ("GetTask", {"worker_id": 1}),
        # no sample-batch source wired (no standby workers): no records
        ("GetSampleBatch", {"n": 2}),
        ("EmbeddingUpdate", {"layer": "t", "ids": np.array([3, 9], dtype=np.int64),
                             "values": rng.standard_normal((2, 4)).astype(np.float32),
                             "set_if_not_exist": True}),
        ("EmbeddingLookup", {"layer": "t", "ids": np.array([9, 4, 3], dtype=np.int64)}),
        ("PSRestoreFromWorker", {"worker_id": 0, "shard_id": 0, "version": 3,
                                 "vec": rng.standard_normal(4).astype(np.float32)}),
        # the observability plane: a phase snapshot (no sink wired: acked),
        # the process's spans (tracing off: unchanged between the calls)
        # and its metrics (their values move with every call: compared by
        # name in the test)
        ("ReportPhaseStats", {"worker_id": 0,
                              "phases": {"compute": {"seconds": 0.5, "count": 2}}}),
        ("GetTrace", {}),
        ("GetMetrics", {}),
    ]


def _assert_same(got, want, where="resp"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, BF16Bits):
        assert isinstance(got, BF16Bits), where
        _assert_same(got.bits, want.bits, where)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert (got.dtype, got.shape) == (want.dtype, want.shape), where
        assert got.tobytes() == want.tobytes(), where
    else:
        assert type(got) is type(want) and got == want, where


@pytest.fixture
def server():
    servers = []

    def start(handlers):
        srv = RpcServer(handlers, port=0)
        srv.start()
        servers.append(srv)
        return srv

    yield start
    for srv in servers:
        srv.stop()


def test_every_ported_method_over_the_socket_matches_in_process(server):
    local, remote = _servicer(), _servicer()
    srv = server(remote.handlers())
    client = RpcClient(f"localhost:{srv.port}")
    client.wait_ready(5)
    inproc = InProcessMaster(local)
    calls = _calls()
    assert {m for m, _ in calls} == set(local.handlers())
    try:
        for method, req in calls:
            got, want = client.call(method, req), inproc.call(method, req)
            if method == "GetMetrics":
                # one process registry, whose wire counters each call moves
                got, want = ({k: sorted(v) for k, v in r.items()} for r in (got, want))
            _assert_same(got, want, method)
    finally:
        client.close()
    assert remote.exactness() == local.exactness() == {
        "version": 5, "init_version": 0, "applied_update_steps": 5
    }
    stats = srv.stats()
    assert stats["calls"] == inproc.calls
    assert set(stats["handler_seconds"]) == set(stats["codec_seconds"]) == set(inproc.calls)


def test_status_codes_carry_grpc_names_and_values():
    for code in StatusCode:
        assert code.value == grpc.StatusCode[code.name].value[0]


def test_unknown_method_is_unimplemented_and_handler_errors_keep_their_codes(server):
    def fenced(req):
        raise PolicyRpcError(StatusCode.FAILED_PRECONDITION, "stale epoch")

    def broken(req):
        raise ValueError("bad shape\nsecond line")

    srv = server({"Fenced": fenced, "Broken": broken, "Echo": lambda req: req})
    client = RpcClient(f"localhost:{srv.port}")
    try:
        with pytest.raises(PolicyRpcError) as e:
            client.call("NoSuchMethod", {})
        assert e.value.code() is StatusCode.UNIMPLEMENTED
        with pytest.raises(PolicyRpcError) as e:
            client.call("Fenced", {})
        assert (e.value.code(), e.value.details()) == (
            StatusCode.FAILED_PRECONDITION, "stale epoch"
        )
        with pytest.raises(PolicyRpcError) as e:
            client.call("Broken", {})
        assert e.value.code() is StatusCode.INTERNAL
        assert e.value.details() == "ValueError: bad shape second line"
        # the connection survives error frames
        assert client.call("Echo", {"x": 1}) == {"x": 1}
    finally:
        client.close()


def test_oversized_request_header_is_refused_before_its_body(server):
    assert transport.MAX_FRAME_BYTES == GRPC_MAX_MESSAGE_LENGTH
    srv = server({"Echo": lambda req: req})
    with socket.create_connection(("127.0.0.1", srv.port), timeout=5) as raw:
        # a header claiming one byte over the limit, and no body: the
        # server must answer from the header alone
        raw.sendall(
            transport._REQ_HEADER.pack(4, transport.MAX_FRAME_BYTES + 1) + b"Echo"
        )
        head = raw.recv(transport._RESP_ERR.size, socket.MSG_WAITALL)
        status, code, dlen = transport._RESP_ERR.unpack(head)
        detail = raw.recv(dlen, socket.MSG_WAITALL).decode()
        assert (status, code) == (1, StatusCode.INVALID_ARGUMENT.value)
        assert "exceeds the limit" in detail
        assert raw.recv(1) == b""  # then the connection is closed
    client = RpcClient(f"localhost:{srv.port}")
    try:
        assert client.call("Echo", {"x": 1}) == {"x": 1}
    finally:
        client.close()


def _closed_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_closed_port_is_unavailable_and_idempotent_calls_retry_on_schedule():
    pauses = []
    client = RpcClient(
        f"localhost:{_closed_port()}", policy=RetryPolicy(sleep_fn=pauses.append)
    )
    with pytest.raises(PolicyRpcError) as e:
        client.call("GetTask", {"worker_id": 0})
    assert e.value.code() is StatusCode.UNAVAILABLE
    assert pauses == []  # GetTask is not idempotent: one attempt
    with pytest.raises(PolicyRpcError) as e:
        client.call("GetModel", {})
    assert e.value.code() is StatusCode.UNAVAILABLE
    want = [RetryPolicy().backoff_for("GetModel", k) for k in (1, 2, 3)]
    assert pauses == want
    t0 = time.monotonic()
    with pytest.raises(PolicyRpcError) as e:
        client.wait_ready(0.3)
    assert e.value.code() is StatusCode.UNAVAILABLE
    assert time.monotonic() - t0 < 3


def test_handler_past_the_timeout_is_deadline_exceeded(server):
    release = threading.Event()

    def slow(req):
        release.wait(5)
        return {}

    srv = server({"Slow": slow})
    client = RpcClient(f"localhost:{srv.port}")
    try:
        with pytest.raises(PolicyRpcError) as e:
            client.call("Slow", {}, timeout=0.2)
        assert e.value.code() is StatusCode.DEADLINE_EXCEEDED
    finally:
        release.set()
        client.close()


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_backoff_schedule_equals_the_reference(seed):
    port, ref = RetryPolicy(seed=seed), jpolicy.RetryPolicy(seed=seed)
    for method in ("GetModel", "GetPSConfig", "ReportTaskResult", "GetTask"):
        for attempt in range(1, 8):
            assert port.backoff_for(method, attempt) == ref.backoff_for(method, attempt)


def test_idempotent_set_is_the_references_over_the_ported_methods():
    ported = (set(_servicer().handlers()) | set(PSShardServicer(0, 1).handlers())
              | set(KVShardServicer(0, 1).handlers()))
    assert policy.IDEMPOTENT_METHODS == jpolicy.IDEMPOTENT_METHODS & ported


@pytest.mark.parametrize(
    "which, extra",
    [
        ("master", []),
        ("master", ["--training_data_dir", "d", "--num_workers", "3", "--output", "o",
                    "--grads_to_wait", "1", "--envs", "A=1,B=2", "--port", "7"]),
        ("worker", ["--worker_id", "2", "--master_addr", "localhost:9"]),
    ],
)
def test_parser_values_equal_the_references_for_every_ported_flag(which, extra):
    port = getattr(targs, f"{which}_parser")()
    ref = getattr(jargs, f"{which}_parser")()
    got = vars(port.parse_args(SPEC_ARGV + extra))
    want = vars(ref.parse_args(SPEC_ARGV + extra))
    assert got.pop("device") == "cuda"
    for dest, value in got.items():
        assert value == want[dest], dest


def test_flags_not_ported_are_rejected():
    with pytest.raises(SystemExit):
        targs.master_parser().parse_args(SPEC_ARGV + ["--sync_bucket_bytes", "4096"])


@pytest.mark.parametrize("data_dir", ["", "shards"])
def test_validate_master_args_agrees_with_the_reference(data_dir):
    argv = SPEC_ARGV + (["--training_data_dir", data_dir] if data_dir else [])
    port = targs.master_parser().parse_args(argv)
    ref = jargs.master_parser().parse_args(argv)
    if not data_dir:
        with pytest.raises(ValueError) as pe:
            targs.validate_master_args(port)
        with pytest.raises(ValueError) as re_:
            jargs.validate_master_args(ref)
        assert str(pe.value) == str(re_.value)
    else:
        assert targs.validate_master_args(port) == jargs.validate_master_args(ref)


def test_collect_shards_agrees_with_the_reference(tmp_path):
    for i, n in enumerate((40, 24, 7)):
        write_learnable_token_records(str(tmp_path / f"s{i}.rio"), n, 16, 64, seed=i)
    (tmp_path / ".hidden").write_bytes(b"")
    (tmp_path / "subdir").mkdir()
    assert collect_shards(str(tmp_path)) == jcollect_shards(str(tmp_path))
    single = str(tmp_path / "s1.rio")
    assert collect_shards(single) == jcollect_shards(single) == {single: 24}
    empty = tmp_path / "subdir"
    with pytest.raises(ValueError):
        collect_shards(str(empty))
    with pytest.raises(ValueError):
        jcollect_shards(str(empty))
    assert collect_shards("") == jcollect_shards("") == {}


def test_worker_parser_accepts_the_forwarded_argv():
    margs = targs.master_parser().parse_args(
        SPEC_ARGV + ["--training_data_dir", "d", "--model_params", "vocab=64",
                     "--device", "cpu", "--log_level", "DEBUG"]
    )
    argv = targs.worker_forward_args(margs, 3, "localhost:1234")
    wargs = targs.worker_parser().parse_args(argv)
    assert (wargs.worker_id, wargs.master_addr) == (3, "localhost:1234")
    for dest in ("model_zoo", "model_def", "model_params", "dataset_fn", "loss",
                 "optimizer", "minibatch_size", "log_level", "device"):
        assert getattr(wargs, dest) == getattr(margs, dest), dest
    assert targs.parse_envs("A=1, B=x=y,,") == jargs.parse_envs("A=1, B=x=y,,")

