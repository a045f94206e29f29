"""Observability self-check and artifact capture.

``python -m elasticdl_tpu_torch.obs --out-dir obs-artifacts`` runs a
small traced probe, the reference's `python -m elasticdl_tpu.obs`: a PS
shard served over the configured transport tier (``EDL_TRANSPORT``), a
handful of pushes and pulls, and the GetTrace scrape; then it writes
three artifacts:

- ``trace.json``    Perfetto-loadable Chrome trace of every probe span
- ``flight.json``   the flight-recorder dump (probe markers included)
- ``metrics.txt``   the Prometheus exposition of the process registry

It exits non-zero when the probe spans are missing (the client AND the
server side of each round trip, and the shard's apply), so a lost hop
shows before anyone stares at an empty timeline. The reference probes a
KV shard; the port probes a PS shard, whose store needs no native build.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m elasticdl_tpu_torch.obs",
                                     description=__doc__)
    parser.add_argument("--out-dir", default="obs-artifacts",
                        help="directory receiving trace.json / flight.json / metrics.txt")
    parser.add_argument("--rounds", type=int, default=8, help="probe RPC round trips")
    args = parser.parse_args(argv)

    import numpy as np

    from elasticdl_tpu_torch.common.constants import ENV_TRACE_SAMPLE
    from elasticdl_tpu_torch.master.ps_shard import PSShardServicer
    from elasticdl_tpu_torch.obs import fetch, flight, metrics, trace
    from elasticdl_tpu_torch.rpc.client import RpcClient
    from elasticdl_tpu_torch.rpc.server import RpcServer

    os.environ[ENV_TRACE_SAMPLE] = "1"
    trace.refresh()

    os.makedirs(args.out_dir, exist_ok=True)
    flight.record("obs_selfcheck_begin", rounds=args.rounds)

    servicer = PSShardServicer(0, 1)
    servicer.register_metrics()
    server = RpcServer(servicer.handlers(), port=0)
    server.start()
    client = RpcClient(f"localhost:{server.port}")
    try:
        client.wait_ready(30)
        with trace.span("obs.selfcheck", cat="probe", root=True):
            # the probe shard is built at generation 0; the epoch stamp
            # keeps the calls on the fenced contract
            client.call("PSInit", {"epoch": 0, "vec": np.zeros(4, np.float32), "version": 0},
                        timeout=30)
            for i in range(args.rounds):
                client.call("PSPushDelta", {"epoch": 0, "delta": np.full(4, float(i), np.float32),
                                            "steps": 1, "base_version": i,
                                            "report_key": f"probe-{i}"}, timeout=30)
                client.call("PSPull", {"epoch": 0}, timeout=30)
        transport = client.tier
        flight.record("obs_selfcheck_probe_done", transport=transport)
        trace_path = os.path.join(args.out_dir, "trace.json")
        fetch.fetch_chrome_trace([client], path=trace_path)
    finally:
        client.close()
        server.stop()

    flight_path = flight.RECORDER.dump(os.path.join(args.out_dir, "flight.json"))
    metrics_path = os.path.join(args.out_dir, "metrics.txt")
    with open(metrics_path, "w") as f:
        f.write(metrics.get_registry().prometheus_text())

    spans = trace.RECORDER.snapshot()
    names = {s["name"] for s in spans}
    missing = {
        "rpc.client.PSPushDelta",
        "rpc.server.PSPushDelta",
        "rpc.client.PSPull",
        "rpc.server.PSPull",
        "ps.apply",
        "obs.selfcheck",
    } - names
    print(f"obs[selfcheck]: transport={transport} spans={len(spans)}")
    print(f"obs[selfcheck]: wrote {trace_path}")
    print(f"obs[selfcheck]: wrote {flight_path}")
    print(f"obs[selfcheck]: wrote {metrics_path}")
    if missing:
        print(f"obs[selfcheck]: FAILED — probe spans missing: {sorted(missing)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
