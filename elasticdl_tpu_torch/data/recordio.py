"""RecordIO: record-granular files with range reads.

The reference's format, read through its pure-Python index path:

    [u32 LE payload_len][u32 crc32(payload)][payload] ...

Reads are zero-copy slices of an mmap of the file.
"""

from __future__ import annotations

import mmap
import os
import struct
import zlib
from typing import Iterator, List, Tuple

import numpy as np

_HEADER = struct.Struct("<II")


class RecordIOWriter:
    """Sequential record writer."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "wb")

    def write(self, payload: bytes):
        if not isinstance(payload, (bytes, bytearray, memoryview)):
            raise TypeError("record payload must be bytes")
        payload = bytes(payload)
        self._f.write(_HEADER.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def build_index(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets, sizes) int64 arrays of every record's payload."""
    offsets: List[int] = []
    sizes: List[int] = []
    filesize = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos + _HEADER.size <= filesize:
            length, _crc = _HEADER.unpack(f.read(_HEADER.size))
            if pos + _HEADER.size + length > filesize:
                raise IOError(f"truncated recordio file: {path}")
            offsets.append(pos + _HEADER.size)
            sizes.append(length)
            pos += _HEADER.size + length
            f.seek(pos)
    return np.asarray(offsets, dtype=np.int64), np.asarray(sizes, dtype=np.int64)


def count_records(path: str) -> int:
    return len(build_index(path)[0])


class RecordIOReader:
    """Zero-copy range reader: yields records [start, end)."""

    def __init__(self, path: str):
        self._path = path
        self._offsets, self._sizes = build_index(path)
        self._f = open(path, "rb")
        try:
            self._mm = (
                mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
                if os.path.getsize(path)
                else None
            )
        except (OSError, ValueError):
            self._f.close()
            raise

    def __len__(self) -> int:
        return len(self._offsets)

    def read(self, idx: int) -> bytes:
        off = int(self._offsets[idx])
        size = int(self._sizes[idx])
        return self._mm[off : off + size]

    def read_range(self, start: int, end: int) -> Iterator[bytes]:
        end = min(end, len(self))
        for i in range(start, end):
            yield self.read(i)

    def close(self):
        if self._mm is not None:
            self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
