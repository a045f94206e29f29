"""Worker-side data plumbing: a cache of open RecordIO readers and the
minibatch split of a task's records."""

from __future__ import annotations

from typing import Dict, Iterator, List

from elasticdl_tpu_torch.data.recordio import RecordIOReader


class ReaderCache:
    """Open (mmapped) RecordIO readers keyed by path."""

    def __init__(self):
        self._readers: Dict[str, RecordIOReader] = {}

    def get(self, path: str) -> RecordIOReader:
        r = self._readers.get(path)
        if r is None:
            r = RecordIOReader(path)
            self._readers[path] = r
        return r

    def close(self):
        for r in self._readers.values():
            r.close()
        self._readers.clear()


def iter_minibatches(
    records: List[bytes], minibatch_size: int
) -> Iterator[List[bytes]]:
    for i in range(0, len(records), minibatch_size):
        yield records[i : i + minibatch_size]
