"""The observability plane, the reference's `elasticdl_tpu/obs/`:
cross-process sync tracing (`obs/trace.py`), one declared-names metrics
surface (`obs/metrics.py`), a crash flight recorder (`obs/flight.py`),
their RPC consumers (`obs/fetch.py`) and the span-derived sync critical
path (`obs/critical_path.py`). `python -m elasticdl_tpu_torch.obs`
runs the self-check probe (`obs/__main__.py`).

`get_trace` and `get_metrics` are the GetTrace and GetMetrics handlers
of every shard servicer: both answer for the hosting process."""

from elasticdl_tpu_torch.obs import fetch, flight, metrics, trace  # noqa: F401


def get_trace(req: dict) -> dict:
    """This process's SpanRecorder contents."""
    return {"spans": trace.RECORDER.snapshot(), "dropped": trace.RECORDER.dropped}


def get_metrics(req: dict) -> dict:
    """This process's MetricsRegistry snapshot."""
    return {"metrics": metrics.get_registry().snapshot()}
