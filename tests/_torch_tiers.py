"""Shared fixture for the port's tests that open a fast transport tier
(tests/test_torch_transport.py, tests/test_torch_shm_job.py).

`EDL_UDS_DIR` points at a fresh short directory of the test's own (an
AF_UNIX path holds at most 107 bytes), so that no port test touches the
directory that the reference's tests sweep. After the test, no socket or
rendezvous file may be left there and no segment of this process's
servers in /dev/shm (the port's names start with "edlt", never with the
reference's "edl-uds-", "edl-shm-" or "edlshm.", which
tests/conftest.py sweeps for); a connection thread that unlinks its
segment may lag the test by a beat, so the check waits up to 5 s.
"""

import os
import shutil
import tempfile
import time

import pytest

from elasticdl_tpu_torch.rpc import transport

LEAK_GRACE_SECONDS = 5.0


def own_segments() -> set:
    """/dev/shm segments of this process's shm servers."""
    mark = f".{os.getpid()}."
    try:
        names = os.listdir("/dev/shm")
    except OSError:
        return set()
    return {n for n in names if n.startswith(transport.SHM_SEGMENT_PREFIX) and mark in n}


def port_files(d: str) -> list:
    return sorted(n for n in os.listdir(d) if n.startswith("edlt"))


@pytest.fixture(autouse=True)
def tier_dir(monkeypatch):
    d = tempfile.mkdtemp(prefix="edlt")
    monkeypatch.setenv("EDL_UDS_DIR", d)
    before = own_segments()
    yield d
    deadline = time.monotonic() + LEAK_GRACE_SECONDS
    while True:
        leaked, files = own_segments() - before, port_files(d)
        if not leaked and not files:
            break
        if time.monotonic() >= deadline:
            shutil.rmtree(d, ignore_errors=True)
            pytest.fail(f"leaked segments {sorted(leaked)}, files {files}")
        time.sleep(0.05)
    shutil.rmtree(d, ignore_errors=True)
