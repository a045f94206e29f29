"""Shard processes: the lifecycle the PS and KV shard groups share.

The reference's `elasticdl_tpu/master/shard_host.py` for the process
mode: both groups (`ps_group.PSShardGroup`, `kv_group.KVShardGroup`) run
N `python -m <entry module>` subprocesses that bind an ephemeral port and
publish it through `--port_file` (no bind races), and differ only in the
entry module and its flags. The lifecycle lives here so that a fix (port
file polling, reaping a partial boot, terminate then kill) cannot drift
between the two.

Each child gets the parent's environment, the transport tier included,
with the socket directory pinned (`EDL_UDS_DIR`), so master, shards and
workers meet in one place, this checkout on `PYTHONPATH`, and its
chaos tags (`rpc/chaos.chaos_env_for`: role "ps" or "kv", target id
the slot), so an inherited `EDL_CHAOS_SPEC` can aim at one slot. The port
files' directory is removed once every shard has published, or when the
boot fails.

A relaunch of one slot (the recovery plane's) boots it alone through the
same path (`shard_ids=[i]`). `collect_metrics` reads each shard
process's metrics registry for the master's GetMetrics.

Not ported yet: the k8s pods.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional, Tuple

from elasticdl_tpu_torch.common.constants import ENV_UDS_DIR
from elasticdl_tpu_torch.common.log_util import get_logger

logger = get_logger(__name__)

# seconds a terminated shard process gets before it is killed
STOP_GRACE_SECONDS = 5.0


def shard_env(role: str, shard_id: int) -> dict:
    """A shard process's environment: the parent's, with the fast tiers'
    socket directory pinned, this checkout importable, and the slot's
    chaos tags (`role` "ps" or "kv" and the shard id, inert when no
    EDL_CHAOS_SPEC is set), so an inherited spec can aim at one slot."""
    from elasticdl_tpu_torch.rpc import transport
    from elasticdl_tpu_torch.rpc.chaos import chaos_env_for

    env = dict(os.environ)
    env.update(chaos_env_for(role, shard_id))
    env.setdefault(ENV_UDS_DIR, transport.uds_dir())
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def spawn_shard_processes(
    n: int,
    entry_module: str,
    flags_fn: Callable[[int], List[str]],
    prefix: str,
    boot_timeout: float,
    shard_ids: Optional[List[int]] = None,
) -> Tuple[List[subprocess.Popen], List[str]]:
    """Boot n shard subprocesses of `entry_module` (shard i gets
    `flags_fn(i)`); returns (processes, endpoints). `shard_ids` names the
    slots to boot instead of range(n) (a relaunch boots one:
    shard_ids=[i], and keeps the slot's chaos target id). A boot failure
    stops every process already spawned before it raises."""
    ids = list(shard_ids) if shard_ids is not None else list(range(n))
    port_dir = tempfile.mkdtemp(prefix=prefix)
    role = "kv" if "kv" in entry_module.rsplit(".", 1)[-1] else "ps"
    procs: List[subprocess.Popen] = []
    endpoints: List[str] = []
    try:
        port_files = []
        for i in ids:
            pf = os.path.join(port_dir, f"shard-{i}.port")
            port_files.append(pf)
            argv = [sys.executable, "-m", entry_module, "--port", "0", "--port_file", pf]
            procs.append(subprocess.Popen(argv + flags_fn(i), env=shard_env(role, i)))
        deadline = time.monotonic() + boot_timeout
        for k, pf in enumerate(port_files):
            while not os.path.exists(pf):
                if procs[k].poll() is not None:
                    raise RuntimeError(f"shard {ids[k]} ({entry_module}) exited "
                                       f"rc={procs[k].returncode} before publishing its port")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"shard {ids[k]} ({entry_module}) did not publish a port")
                time.sleep(0.05)
            with open(pf) as f:
                endpoints.append(f"localhost:{int(f.read().strip())}")
    except BaseException:
        stop_shard_processes(procs)
        raise
    finally:
        shutil.rmtree(port_dir, ignore_errors=True)
    return procs, endpoints


def stop_shard_processes(procs: List[subprocess.Popen]):
    """Terminate, wait out the grace period, then kill."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=STOP_GRACE_SECONDS)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def collect_metrics(endpoints: List[str], kind: str) -> dict:
    """Each shard process's MetricsRegistry snapshot, keyed
    `<kind><i>` ("ps0", "kv1"), for the master's GetMetrics: one
    best-effort GetMetrics call each (a dead shard contributes nothing
    rather than failing the scrape)."""
    from elasticdl_tpu_torch.rpc.client import RpcClient

    out = {}
    for i, endpoint in enumerate(endpoints):
        c = RpcClient(endpoint)
        try:
            out[f"{kind}{i}"] = c.call("GetMetrics", {}, timeout=10.0).get("metrics", {})
        except Exception as e:  # noqa: BLE001 - the scrape is best-effort
            logger.warning("%s shard %d: GetMetrics failed: %s", kind, i, e)
        finally:
            c.close()
    return out
