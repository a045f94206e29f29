"""The embedding store: PS-resident sparse tables, keyed by (layer, id).

The reference's `elasticdl_tpu/master/embedding_store.py`, two back ends
behind one API:

- `lookup(layer, ids)` -> (values [n, dim], unknown_index [k]): rows of
  unknown ids come back zero-filled and their positions listed, so the
  caller can lazily initialize them;
- `update(layer, ids, values, set_if_not_exist=False)`: a batch write;
  with `set_if_not_exist` only absent ids are written (SETNX), which
  gives race-free lazy init across concurrent workers: one writer wins;
- `snapshot()` -> `{layer: {id: row}}` and `restore(snapshot)`, for
  checkpoints; `len(store)` counts every row of every layer.

`NativeEmbeddingStore` runs the C++ library `embedding_cpp/
embedding_store.cc`: per-layer row arenas with an int64 -> row hash
index and readers-writer locks, one C call per batch, loaded over ctypes
(which releases the GIL, so concurrent RPC threads look up in
parallel). It is compiled at first use with `g++ -O3 -shared -fPIC`
into `embedding_cpp/_build/`, under `ops/build.py`'s scheme: a hash of
the source and flags in the library's name, an exclusive `flock`, and a
temporary file renamed into place, so processes that start together
(the master and its KV shards) build once. `PyEmbeddingStore` is the
lock-striped dict store. `EmbeddingStore()` returns the native store
unless `EDL_TPU_NO_NATIVE_KV=1` or the library does not build (then it
logs a warning and returns the Python one). Optimizer slot rows live in
the same store under `layer/slot/<name>` (`sparse_optimizer.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.common.constants import ENV_NO_NATIVE_KV
from elasticdl_tpu_torch.common.log_util import get_logger

logger = get_logger(__name__)

_NUM_SHARDS = 8

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "embedding_cpp", "embedding_store.cc")
BUILD_DIR = os.path.join(_HERE, "embedding_cpp", "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)

_native_lock = threading.Lock()
_native: Dict[str, Optional[ctypes.CDLL]] = {}  # library path -> lib, None: failed


def _configure(lib: ctypes.CDLL):
    lib.edlkv_new.restype = ctypes.c_void_p
    lib.edlkv_free.argtypes = [ctypes.c_void_p]
    lib.edlkv_dim.restype = ctypes.c_int64
    lib.edlkv_dim.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.edlkv_lookup.restype = ctypes.c_int64
    lib.edlkv_lookup.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, _I64P, ctypes.c_int64,
        _F32P, ctypes.c_int64, _I64P,
    ]
    lib.edlkv_update.restype = ctypes.c_int64
    lib.edlkv_update.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, _I64P, ctypes.c_int64,
        _F32P, ctypes.c_int64, ctypes.c_int,
    ]
    lib.edlkv_rows.restype = ctypes.c_int64
    lib.edlkv_rows.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.edlkv_total_rows.restype = ctypes.c_int64
    lib.edlkv_total_rows.argtypes = [ctypes.c_void_p]
    lib.edlkv_num_layers.restype = ctypes.c_int64
    lib.edlkv_num_layers.argtypes = [ctypes.c_void_p]
    lib.edlkv_layer_name.restype = ctypes.c_int64
    lib.edlkv_layer_name.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.edlkv_export.restype = ctypes.c_int64
    lib.edlkv_export.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, _I64P, _F32P,
        ctypes.c_int64, ctypes.c_int64,
    ]


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libedlkv-{digest.hexdigest()[:16]}.so")


def build_native() -> str:
    """Compile the store's library unless it exists; returns its path.
    Raises RuntimeError when no C++ compiler is found or it fails."""
    from elasticdl_tpu_torch.ops.build import compile_once

    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) found for the native embedding store")
    return compile_once(
        library_path(),
        lambda tmp: [cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
        os.path.join(BUILD_DIR, "embedding_store.log"),
    )


def load_native() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None (with one warning)
    when it cannot be built or loaded."""
    with _native_lock:
        path = library_path()
        if path not in _native:
            try:
                lib = ctypes.CDLL(build_native())
                _configure(lib)
                _native[path] = lib
            except Exception as e:
                logger.warning("native embedding store unavailable (%s); "
                               "using the Python store", e)
                _native[path] = None
        return _native[path]


class EmbeddingStore:
    """Factory base: `EmbeddingStore()` returns the native store when its
    library loads (and EDL_TPU_NO_NATIVE_KV is not "1"), else the Python
    store; both are subclasses."""

    def __new__(cls, *args, **kwargs):
        if cls is EmbeddingStore:
            native = os.environ.get(ENV_NO_NATIVE_KV) != "1" and load_native() is not None
            impl = NativeEmbeddingStore if native else PyEmbeddingStore
            return super().__new__(impl)
        return super().__new__(cls)


class NativeEmbeddingStore(EmbeddingStore):
    def __init__(self):
        self._lib = load_native()
        if self._lib is None:
            raise RuntimeError("the native embedding store's library did not build")
        self._h = ctypes.c_void_p(self._lib.edlkv_new())

    def __del__(self):  # interpreter teardown may have dropped either
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.edlkv_free(h)

    @staticmethod
    def _ids_buf(ids) -> np.ndarray:
        return np.ascontiguousarray(np.asarray(ids, dtype=np.int64).reshape(-1))

    def lookup(self, layer: str, ids) -> Tuple[np.ndarray, np.ndarray]:
        """(values [n, dim], unknown_index [k]); unknown rows are zeros."""
        ids_a = self._ids_buf(ids)
        n = ids_a.shape[0]
        key = layer.encode()
        dim = self._lib.edlkv_dim(self._h, key)
        if dim == 0:  # layer never written: everything is unknown
            return np.zeros((n, 0), dtype=np.float32), np.arange(n, dtype=np.int64)
        out = np.empty((n, dim), dtype=np.float32)
        unknown = np.empty(n, dtype=np.int64)
        misses = self._lib.edlkv_lookup(
            self._h, key, ids_a.ctypes.data_as(_I64P), n,
            out.ctypes.data_as(_F32P), dim, unknown.ctypes.data_as(_I64P),
        )
        if misses < 0:
            raise ValueError(f"embedding dim mismatch for layer {layer}")
        return out, unknown[:misses].copy()

    def update(self, layer: str, ids, values, set_if_not_exist: bool = False):
        """Batch write (copied into the arenas); SETNX with
        `set_if_not_exist`. Within one call a later duplicate id wins."""
        ids_a = self._ids_buf(ids)
        vals = np.ascontiguousarray(np.asarray(values, dtype=np.float32))
        vals = vals.reshape(ids_a.shape[0], -1)
        if ids_a.shape[0] == 0:
            return
        written = self._lib.edlkv_update(
            self._h, layer.encode(), ids_a.ctypes.data_as(_I64P), ids_a.shape[0],
            vals.ctypes.data_as(_F32P), vals.shape[1], 1 if set_if_not_exist else 0,
        )
        if written < 0:
            raise ValueError(
                f"embedding dim mismatch for layer {layer}: table dim "
                f"{self._lib.edlkv_dim(self._h, layer.encode())}, got {vals.shape[1]}"
            )

    def _layers(self) -> List[str]:
        out = []
        buf = ctypes.create_string_buffer(4096)
        for i in range(self._lib.edlkv_num_layers(self._h)):
            if self._lib.edlkv_layer_name(self._h, i, buf, len(buf)) >= 0:
                out.append(buf.value.decode())
        return out

    def snapshot(self) -> Dict[str, Dict[int, np.ndarray]]:
        """Every table as {layer: {id: row}} (copies)."""
        out: Dict[str, Dict[int, np.ndarray]] = {}
        for layer in self._layers():
            key = layer.encode()
            dim = self._lib.edlkv_dim(self._h, key)
            rows = self._lib.edlkv_rows(self._h, key)
            ids = np.empty(rows, dtype=np.int64)
            vals = np.empty((rows, dim), dtype=np.float32)
            # the capacity bounds the C side's writes: a concurrent
            # update may grow the table after edlkv_rows
            n = self._lib.edlkv_export(
                self._h, key, ids.ctypes.data_as(_I64P), vals.ctypes.data_as(_F32P), dim, rows
            )
            out[layer] = {int(ids[j]): vals[j].copy() for j in range(max(n, 0))}
        return out

    def restore(self, snap: Dict[str, Dict[int, np.ndarray]]):
        for layer, rows in snap.items():
            if not rows:
                continue
            ids = np.fromiter(rows.keys(), dtype=np.int64, count=len(rows))
            vals = np.stack([np.asarray(r, np.float32) for r in rows.values()])
            self.update(layer, ids, vals)

    def __len__(self):
        return self._lib.edlkv_total_rows(self._h)


class PyEmbeddingStore(EmbeddingStore):
    """The Python store: dicts striped over locks."""

    def __init__(self):
        self._shards: List[Dict[Tuple[str, int], np.ndarray]] = [
            {} for _ in range(_NUM_SHARDS)
        ]
        self._locks = [threading.Lock() for _ in range(_NUM_SHARDS)]

    @staticmethod
    def _shard_of(key: Tuple[str, int]) -> int:
        return hash(key) % _NUM_SHARDS

    def lookup(self, layer: str, ids) -> Tuple[np.ndarray, np.ndarray]:
        rows: List[Optional[np.ndarray]] = []
        unknown = []
        for pos, raw_id in enumerate(np.asarray(ids).tolist()):
            key = (layer, int(raw_id))
            s = self._shard_of(key)
            with self._locks[s]:
                row = self._shards[s].get(key)
            if row is None:
                unknown.append(pos)
            rows.append(row)
        dim = next((r.shape[0] for r in rows if r is not None), None)
        if dim is None:
            return np.zeros((len(rows), 0), dtype=np.float32), np.asarray(unknown, dtype=np.int64)
        out = np.zeros((len(rows), dim), dtype=np.float32)
        for i, r in enumerate(rows):
            if r is not None:
                out[i] = r
        return out, np.asarray(unknown, dtype=np.int64)

    def update(self, layer: str, ids, values, set_if_not_exist: bool = False):
        """Each row is copied in (a request's arrays may be views of a
        transport buffer that the next request overwrites)."""
        values = np.asarray(values, dtype=np.float32)
        for raw_id, row in zip(np.asarray(ids).tolist(), values):
            key = (layer, int(raw_id))
            s = self._shard_of(key)
            with self._locks[s]:
                if set_if_not_exist and key in self._shards[s]:
                    continue
                self._shards[s][key] = np.array(row, dtype=np.float32)

    def snapshot(self) -> Dict[str, Dict[int, np.ndarray]]:
        out: Dict[str, Dict[int, np.ndarray]] = {}
        for s, lock in zip(self._shards, self._locks):
            with lock:
                for (layer, raw_id), row in s.items():
                    out.setdefault(layer, {})[raw_id] = row.copy()
        return out

    def restore(self, snap: Dict[str, Dict[int, np.ndarray]]):
        for layer, rows in snap.items():
            for raw_id, row in rows.items():
                key = (layer, int(raw_id))
                s = self._shard_of(key)
                with self._locks[s]:
                    self._shards[s][key] = np.array(row, dtype=np.float32)

    def __len__(self):
        return sum(len(s) for s in self._shards)
