"""Tensor codec: pytrees of numpy arrays <-> wire frames, and the flat layer.

Two jobs, both host-side numpy:

1. **The flat layer.** The model and every gradient ride the wire as ONE
   float32 vector: the leaves of the parameter tree concatenated in the
   reference's leaf order (`jax.tree_util` order: dict keys sorted,
   depth-first; lists and tuples in order; None has no leaves). PS
   updates and every gradient are positions in this vector, so the
   order here must equal the reference's `codec.ravel_np` exactly — a
   different order would misroute updates without raising.
   `tree_flatten` / `tree_unflatten` / `ravel_np` / `make_unraveler`
   reproduce that contract with the standard library alone.

2. **Frames.** A pytree (nested dict/list/tuple of arrays, scalars,
   strings, None) packs into one buffer:

       offset  size  field
       0       1     0xC1 frame magic
       1       1     codec version (0x01: JSON header)
       2       4     u32 LE header length H
       6       2     u16 LE header pad P (zeros aligning the payload)
       8       H     UTF-8 JSON header: the pytree with every array
                     replaced by a descriptor {"__nd__": 1, "d": dtype,
                     "s": shape, "o": payload offset, "n": byte length}
       8+H     P     zero padding so the payload starts 64-byte aligned
       8+H+P   ...   payload: raw array bytes, each segment 64-byte
                     aligned relative to the frame start

   The layout follows the reference's v2 frame with a JSON header in
   place of msgpack; the bytes are not compatible with the reference's.
   Decoding returns `np.frombuffer` views into the frame.

   Files that both packages read (checkpoints) are written as the
   reference's own v2 frame, `dumps_v2`: the same layout with the
   version byte 0x02 and the header in msgpack (a subset written out
   here: maps, arrays, strings, ints, floats, bools, nil),
   arrays as `{"__nd__": True, ...}` descriptors and tuples as
   `{"__tp__": [...]}`. `loads` reads either version.

A `bytes` leaf (a raw record: GetSampleBatch) travels as a uint8 payload
segment under the dtype tag "bytes" and decodes to a `bytes` copy.

`IndexedRows` (the sparse plane's row-indexed gradient: an embedding
table's rows by id) travels as `{"__ir__": 1, "v": values, "i":
indices}`, two payload segments; in the reference's v2 frame it is the
reference's own `{"__ir__": True, "v": ..., "i": ...}`, byte for byte.
The v2 frame also takes integer dict keys (an embedding snapshot's
`{layer: {id: row}}`, as a checkpoint carries it); the JSON header
takes string keys only.

bfloat16 has no numpy dtype without `ml_dtypes`, so a bf16 array travels
as its uint16 bit patterns under the dtype tag "bfloat16" and decodes to
`BF16Bits`; `as_f32` widens it. The compressed window deltas
(`QuantizedDelta`, `SparseDelta`, nested for top-k over int8) travel as
tagged header objects whose arrays are ordinary payload segments;
`delta_to_f32` decodes every delta form, and `slice_delta` cuts any form
to a PS shard's range without decoding it (an int8 slice keeps the
`offset` of its first element in the chunks its scales cover).
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Any, Callable, List, Tuple

import numpy as np

FRAME_MAGIC = 0xC1
CODEC_VERSION = 1
#: the reference's frame version: the same layout, a msgpack header
REFERENCE_CODEC_VERSION = 2
#: magic, version, u32 header length, u16 header pad
_FRAME_PREFIX = struct.Struct("<BBIH")
_SEGMENT_ALIGN = 64

_ND_KEY = "__nd__"
_TUPLE_KEY = "__tp__"
_QD_KEY = "__qd__"
_SD_KEY = "__sd__"
_IR_KEY = "__ir__"
_BF16_TAG = "bfloat16"
_BYTES_TAG = "bytes"


# --------------------------------------------------------------------------
# bfloat16 as bits


@dataclasses.dataclass
class BF16Bits:
    """A bfloat16 array held as its uint16 bit patterns."""

    bits: np.ndarray  # uint16, any shape

    def __post_init__(self):
        self.bits = np.asarray(self.bits)
        if self.bits.dtype != np.uint16:
            raise TypeError(f"BF16Bits needs uint16 bits, got {self.bits.dtype}")

    @property
    def shape(self):
        return self.bits.shape

    @classmethod
    def from_f32(cls, a) -> "BF16Bits":
        """Round float32 to bfloat16, nearest-even (NaN stays NaN)."""
        u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
        rounded = (u + (0x7FFF + ((u >> 16) & 1))) >> 16
        nan = (u & 0x7FFFFFFF) > 0x7F800000
        bits = np.where(nan, (u >> 16) | 0x40, rounded).astype(np.uint16)
        return cls(bits)

    def to_f32(self) -> np.ndarray:
        return (self.bits.astype(np.uint32) << 16).view(np.float32)


def narrow(vec: np.ndarray, model_dtype: str | None):
    """A float32 model vector in the wire dtype a request asked for
    (bfloat16 halves the bytes; the receiver widens it again)."""
    if model_dtype == "bfloat16":
        return BF16Bits.from_f32(vec)
    if model_dtype and model_dtype != "float32":
        raise ValueError(f"unsupported model_dtype {model_dtype!r}")
    return vec


def as_f32(a: Any) -> np.ndarray:
    """Float32 view of `a` when it already is f32, else a widening copy."""
    if isinstance(a, BF16Bits):
        return a.to_f32()
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a
    return a.astype(np.float32)


# --------------------------------------------------------------------------
# row-indexed tensors (the sparse plane)


@dataclasses.dataclass
class IndexedRows:
    """A row-indexed tensor: `values[k]` is the row of id `indices[k]`
    (an embedding table's gradient rows, or the rows of an update)."""

    values: np.ndarray  # [n, dim]
    indices: np.ndarray  # [n] int64

    def __post_init__(self):
        self.values = np.asarray(self.values)
        self.indices = np.asarray(self.indices, dtype=np.int64)


def merge_indexed_rows(slices: List[IndexedRows], dedup: bool = False) -> IndexedRows:
    """Concatenate IndexedRows; with `dedup`, the rows of a repeated id
    are summed in float32 (the math the PS's sparse apply runs first),
    by a stable sort and `np.add.reduceat`, as the reference does, so the
    sums equal its bit for bit."""
    out = IndexedRows(
        values=np.concatenate([s.values for s in slices], axis=0),
        indices=np.concatenate([s.indices for s in slices], axis=0),
    )
    if not dedup:
        return out
    uniq, inverse = np.unique(out.indices, return_inverse=True)
    vals = np.asarray(out.values, dtype=np.float32)
    if len(uniq) == 0:
        return IndexedRows(values=np.zeros((0,) + vals.shape[1:], dtype=np.float32), indices=uniq)
    order = np.argsort(inverse, kind="stable")
    starts = np.searchsorted(inverse[order], np.arange(len(uniq)))
    return IndexedRows(values=np.add.reduceat(vals[order], starts, axis=0), indices=uniq)


# --------------------------------------------------------------------------
# compressed wire deltas (the window sync's int8 and top-k forms)
#
# Both are biased compressors: the worker folds the compression error into
# an f32 error-feedback residual and sends it with the next delta, so the
# receiver applies the decoded f32 delta as if it were dense.

#: Elements per int8 scale chunk (one f32 scale per 2048 int8 values).
DEFAULT_INT8_CHUNK = 2048


@dataclasses.dataclass
class QuantizedDelta:
    """int8 per-chunk quantization of a dense f32 vector: chunk c
    (elements [c*chunk, (c+1)*chunk)) is q = clip(rint(v / scale[c]),
    -127, 127) with scale[c] = max|v| / 127 over the chunk; an all-zero
    chunk takes scale 1.0, so it decodes to exact zeros."""

    q: np.ndarray  # [n] int8
    scale: np.ndarray  # [nchunks] f32
    chunk: int
    # absolute position of q[0] in the vector whose chunks `scale`
    # covers: nonzero for a PS-shard slice (`slice`), whose first chunk
    # may start before it
    offset: int = 0

    def __post_init__(self):
        self.q = np.asarray(self.q)
        self.scale = np.asarray(self.scale)
        self.chunk = int(self.chunk)
        self.offset = int(self.offset)

    @property
    def n(self) -> int:
        return int(self.q.size)

    def slice(self, start: int, stop: int) -> "QuantizedDelta":
        """Elements [start, stop), the scales of the chunks they overlap."""
        start, stop = int(start), int(stop)
        abs_start = self.offset + start
        first_chunk = self.offset // self.chunk
        if stop <= start:
            return QuantizedDelta(q=self.q[:0], scale=self.scale[:0], chunk=self.chunk,
                                  offset=abs_start)
        lo = abs_start // self.chunk - first_chunk
        hi = (self.offset + stop - 1) // self.chunk - first_chunk + 1
        return QuantizedDelta(q=self.q[start:stop], scale=self.scale[lo:hi], chunk=self.chunk,
                              offset=abs_start)

    def dequantize(self) -> np.ndarray:
        """Dense f32: each q times the scale of its chunk."""
        first_chunk = self.offset // self.chunk
        idx = (self.offset + np.arange(self.q.size)) // self.chunk - first_chunk
        return self.q.astype(np.float32) * np.asarray(self.scale, dtype=np.float32)[idx]


@dataclasses.dataclass
class SparseDelta:
    """A top-k sparsified vector of length n: `values[j]` sits at
    `indices[j]` (sorted ascending, unique), every other entry is zero.
    `values` is an f32 array, `BF16Bits`, or a `QuantizedDelta` over the
    packed values (top-k over int8)."""

    indices: np.ndarray  # [k] integer
    values: Any
    n: int

    def __post_init__(self):
        self.indices = np.asarray(self.indices)
        if not np.issubdtype(self.indices.dtype, np.integer):
            raise TypeError(
                f"SparseDelta indices must be integer, got {self.indices.dtype}"
            )
        if not isinstance(self.values, (QuantizedDelta, BF16Bits)):
            self.values = np.asarray(self.values)
        self.n = int(self.n)

    @property
    def k(self) -> int:
        return int(self.indices.size)

    def slice(self, start: int, stop: int) -> "SparseDelta":
        """Elements [start, stop), the indices rebased to the range."""
        start, stop = int(start), int(stop)
        lo = int(np.searchsorted(self.indices, start, side="left"))
        hi = int(np.searchsorted(self.indices, stop, side="left"))
        if isinstance(self.values, QuantizedDelta):
            values = self.values.slice(lo, hi)
        elif isinstance(self.values, BF16Bits):
            values = BF16Bits(self.values.bits[lo:hi])
        else:
            values = self.values[lo:hi]
        return SparseDelta(indices=self.indices[lo:hi] - start, values=values,
                           n=max(0, stop - start))

    def dense(self) -> np.ndarray:
        out = np.zeros(self.n, dtype=np.float32)
        out[self.indices] = delta_to_f32(self.values)
        return out


def quantize_int8(vec, chunk: int = DEFAULT_INT8_CHUNK) -> QuantizedDelta:
    """Host int8 per-chunk quantization of a dense f32 vector: the spec
    the worker's on-device quantizer is held to bit for bit."""
    vec = np.asarray(vec, dtype=np.float32).ravel()
    n = vec.size
    chunk = int(chunk)
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    nchunks = -(-n // chunk)
    pad = nchunks * chunk - n
    blocks = (np.pad(vec, (0, pad)) if pad else vec).reshape(nchunks, chunk)
    scale = (
        np.abs(blocks).max(axis=1) / 127.0 if nchunks else np.zeros(0, np.float32)
    )
    scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
    q = np.clip(np.rint(blocks / scale[:, None]), -127, 127).astype(np.int8)
    return QuantizedDelta(q=q.reshape(-1)[:n], scale=scale, chunk=chunk)


def delta_length(obj: Any) -> int:
    """Dense length of a wire delta in any form."""
    if isinstance(obj, (QuantizedDelta, SparseDelta)):
        return obj.n
    if isinstance(obj, BF16Bits):
        return int(obj.bits.size)
    return int(np.asarray(obj).size)


def slice_delta(obj: Any, start: int, stop: int) -> Any:
    """Elements [start, stop) of a wire delta in its own form: the
    PS-shard fan-out's split (`rpc/ps_client.py`), which never
    decompresses."""
    if isinstance(obj, (QuantizedDelta, SparseDelta)):
        return obj.slice(start, stop)
    if isinstance(obj, BF16Bits):
        return BF16Bits(obj.bits[start:stop])
    return np.asarray(obj)[start:stop]


def delta_nbytes(obj: Any) -> int:
    """Payload bytes of a wire delta in any form (framing not counted)."""
    if isinstance(obj, QuantizedDelta):
        return int(obj.q.nbytes + obj.scale.nbytes)
    if isinstance(obj, SparseDelta):
        return int(obj.indices.nbytes) + delta_nbytes(obj.values)
    if isinstance(obj, BF16Bits):
        return int(obj.bits.nbytes)
    return int(np.asarray(obj).nbytes)


def delta_to_f32(obj: Any, n: int | None = None) -> np.ndarray:
    """Decode any wire delta form to a dense f32 vector: f32 stays a
    view, bf16 widens, QuantizedDelta dequantizes, SparseDelta
    densifies. The one decode point of the PS's apply sites."""
    if isinstance(obj, QuantizedDelta):
        out = obj.dequantize()
    elif isinstance(obj, SparseDelta):
        out = obj.dense()
    else:
        out = as_f32(obj)
    if n is not None and out.size != n:
        raise ValueError(f"delta length {out.size} != expected {n}")
    return out


# --------------------------------------------------------------------------
# the flat layer (reference leaf order)

_LEAF = ("leaf",)


def tree_flatten(tree) -> Tuple[list, tuple]:
    """(leaves, treedef) in the reference's leaf order."""
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", tuple(keys), tuple(walk(node[k]) for k in keys))
        if isinstance(node, list):
            return ("list", tuple(walk(v) for v in node))
        if isinstance(node, tuple):
            return ("tuple", tuple(walk(v) for v in node))
        if node is None:
            return ("none",)
        leaves.append(node)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef: tuple, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        if kind == "list":
            return [build(c) for c in d[1]]
        if kind == "tuple":
            return tuple(build(c) for c in d[1])
        return None

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError("tree structures differ")
        others.append(r_leaves)
    return tree_unflatten(
        treedef, [fn(*xs) for xs in zip(leaves, *others)]
    )


def tree_paths(tree) -> List[Tuple[str, ...]]:
    """Key path of every leaf, in leaf order (dict keys and list indices
    as strings) — how the worker finds a module parameter for a leaf."""
    paths: list = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + (str(i),))
        elif node is not None:
            paths.append(prefix)

    walk(tree, ())
    return paths


def ravel_np(tree) -> np.ndarray:
    """Concatenate a float pytree into ONE contiguous float32 vector."""
    return np.concatenate(
        [as_f32(leaf).ravel() for leaf in tree_leaves(tree)]
    )


def template_meta(template) -> tuple:
    """(shapes, sizes, treedef) of a pytree — the unravel plan."""
    leaves, treedef = tree_flatten(template)
    shapes = [tuple(np.shape(leaf)) for leaf in leaves]
    sizes = [int(np.prod(s, dtype=np.int64)) for s in shapes]
    return shapes, sizes, treedef


def make_unraveler(template):
    """Reusable `vec -> pytree` closure (slice + reshape views)."""
    shapes, sizes, treedef = template_meta(template)
    total = sum(sizes)

    def unravel(vec) -> Any:
        vec = np.asarray(vec, dtype=np.float32)
        if vec.size != total:
            raise ValueError(
                f"flat vector size {vec.size} != template size {total}"
            )
        out, off = [], 0
        for shape, n in zip(shapes, sizes):
            out.append(vec[off : off + n].reshape(shape))
            off += n
        return tree_unflatten(treedef, out)

    return unravel


# --------------------------------------------------------------------------
# frames


class _FrameBuilder:
    """Collects payload segments and assigns 64-byte-aligned offsets."""

    __slots__ = ("segments", "offset")

    def __init__(self):
        self.segments: list = []  # [(pad_before, uint8 view)]
        self.offset = 0

    def add(self, seg: np.ndarray) -> int:
        pad = (-self.offset) % _SEGMENT_ALIGN
        off = self.offset + pad
        self.segments.append((pad, seg))
        self.offset = off + seg.nbytes
        return off


def _descriptor(a: np.ndarray, dtype_tag: str, builder: _FrameBuilder) -> dict:
    shape = list(a.shape)
    seg = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    off = builder.add(seg)
    return {_ND_KEY: 1, "d": dtype_tag, "s": shape, "o": off, "n": seg.nbytes}


def _build_header_tree(obj: Any, builder: _FrameBuilder, int_keys: bool = False) -> Any:
    if isinstance(obj, BF16Bits):
        return _descriptor(obj.bits, _BF16_TAG, builder)
    if isinstance(obj, IndexedRows):
        return {_IR_KEY: 1, "v": _build_header_tree(obj.values, builder),
                "i": _build_header_tree(obj.indices, builder)}
    if isinstance(obj, QuantizedDelta):
        qd = {
            "q": _build_header_tree(obj.q, builder),
            "scale": _build_header_tree(obj.scale, builder),
            "chunk": obj.chunk,
        }
        if obj.offset:
            qd["offset"] = obj.offset
        return {_QD_KEY: qd}
    if isinstance(obj, SparseDelta):
        return {_SD_KEY: {
            "indices": _build_header_tree(obj.indices, builder),
            "values": _build_header_tree(obj.values, builder),
            "n": obj.n,
        }}
    if isinstance(obj, (bytes, bytearray)):
        return _descriptor(np.frombuffer(obj, np.uint8), _BYTES_TAG, builder)
    if isinstance(obj, np.ndarray):
        if obj.dtype.kind not in "biuf":
            raise TypeError(f"cannot encode array of dtype {obj.dtype}")
        return _descriptor(obj, obj.dtype.str, builder)
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if isinstance(k, (int, np.integer)) and not isinstance(k, bool) and int_keys:
                k = int(k)
            elif not isinstance(k, str):
                raise TypeError(f"frame dict keys must be str, got {k!r}")
            out[k] = _build_header_tree(v, builder, int_keys)
        return out
    if isinstance(obj, list):
        return [_build_header_tree(v, builder, int_keys) for v in obj]
    if isinstance(obj, tuple):
        return {_TUPLE_KEY: [_build_header_tree(v, builder, int_keys) for v in obj]}
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    if isinstance(obj, (str, bool, int, float)) or obj is None:
        return obj
    raise TypeError(f"cannot encode {type(obj)!r}")


def dumps(obj: Any) -> bytes:
    """Serialize a pytree as one frame."""
    builder = _FrameBuilder()
    header = json.dumps(
        _build_header_tree(obj, builder), separators=(",", ":")
    ).encode()
    return _join_frame(CODEC_VERSION, header, builder)


def _reference_header_tree(tree: Any) -> Any:
    """The port's header tree in the reference's v2 terms: array
    descriptors flagged True, no compressed deltas."""
    if isinstance(tree, dict):
        if _QD_KEY in tree or _SD_KEY in tree:
            raise TypeError("compressed deltas have no reference-frame form here")
        if _IR_KEY in tree:
            return {_IR_KEY: True, "v": _reference_header_tree(tree["v"]),
                    "i": _reference_header_tree(tree["i"])}
        if _ND_KEY in tree:
            if tree["d"] == _BYTES_TAG:
                raise TypeError("bytes leaves have no reference-frame form here")
            return {**tree, _ND_KEY: True}
        return {k: _reference_header_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_reference_header_tree(v) for v in tree]
    return tree


def dumps_v2(obj: Any) -> bytes:
    """Serialize a pytree of arrays, containers and scalars as the
    reference's v2 frame (its `codec.dumps`): checkpoint files."""
    builder = _FrameBuilder()
    header = _mp_pack(_reference_header_tree(_build_header_tree(obj, builder, int_keys=True)))
    return _join_frame(REFERENCE_CODEC_VERSION, header, builder)


def _join_frame(version: int, header: bytes, builder: _FrameBuilder) -> bytes:
    head_pad = (-(_FRAME_PREFIX.size + len(header))) % _SEGMENT_ALIGN
    parts = [
        _FRAME_PREFIX.pack(FRAME_MAGIC, version, len(header), head_pad),
        header,
        b"\x00" * head_pad,
    ]
    for pad, seg in builder.segments:
        parts.append(b"\x00" * pad)
        parts.append(seg)
    return b"".join(parts)


def _read_descriptor(m: dict, frame, payload_start: int) -> Any:
    tag = m["d"]
    dt = (np.dtype(np.uint16) if tag == _BF16_TAG
          else np.dtype(np.uint8) if tag == _BYTES_TAG else np.dtype(tag))
    shape = [int(s) for s in m["s"]]
    count = int(np.prod(shape, dtype=np.int64))
    if m["n"] != count * dt.itemsize:
        raise ValueError(
            f"corrupt frame descriptor: {m['n']} bytes for dtype {tag} "
            f"shape {shape}"
        )
    arr = np.frombuffer(
        frame, dtype=dt, count=count, offset=payload_start + int(m["o"])
    ).reshape(shape)
    if tag == _BYTES_TAG:
        return arr.tobytes()
    return BF16Bits(arr) if tag == _BF16_TAG else arr


def loads(data) -> Any:
    """Deserialize a frame, the port's or the reference's v2; arrays
    are read-only views into `data`."""
    if len(data) < _FRAME_PREFIX.size or data[0] != FRAME_MAGIC:
        raise ValueError("not a codec frame (bad magic)")
    _magic, version, hlen, pad = _FRAME_PREFIX.unpack_from(data, 0)
    if version not in (CODEC_VERSION, REFERENCE_CODEC_VERSION):
        raise ValueError(f"unsupported codec frame version {version}")
    header_end = _FRAME_PREFIX.size + hlen
    payload_start = header_end + pad

    def hook(m: dict) -> Any:
        if _ND_KEY in m:
            return _read_descriptor(m, data, payload_start)
        if _TUPLE_KEY in m:
            return tuple(m[_TUPLE_KEY])
        if _IR_KEY in m:
            return IndexedRows(values=m["v"], indices=m["i"])
        if _QD_KEY in m:
            return QuantizedDelta(**m[_QD_KEY])
        if _SD_KEY in m:
            return SparseDelta(**m[_SD_KEY])
        return m

    header = bytes(data[_FRAME_PREFIX.size:header_end])
    if version == REFERENCE_CODEC_VERSION:
        return _mp_unpack(header, hook)
    return json.loads(header, object_hook=hook)


# --------------------------------------------------------------------------
# the msgpack subset of the reference frame's header


# (code, struct format, smallest value, bound) of msgpack's sized ints,
# in the order the reference's encoder tries them
_MP_INTS = (
    (0xCC, ">B", 0, 1 << 8), (0xCD, ">H", 0, 1 << 16),
    (0xCE, ">I", 0, 1 << 32), (0xCF, ">Q", 0, 1 << 64),
    (0xD0, ">b", -(1 << 7), 0), (0xD1, ">h", -(1 << 15), 0),
    (0xD2, ">i", -(1 << 31), 0), (0xD3, ">q", -(1 << 63), 0),
)


def _mp_pack(obj: Any) -> bytes:
    out = bytearray()

    def head(n: int, fix: int, fix_max: int, c8, c16: int, c32: int):
        """A sized type's header: fixed form, then 8-, 16-, 32-bit."""
        if n <= fix_max:
            out.append(fix | n)
        elif c8 is not None and n < 1 << 8:
            out.extend(struct.pack(">BB", c8, n))
        elif n < 1 << 16:
            out.extend(struct.pack(">BH", c16, n))
        else:
            out.extend(struct.pack(">BI", c32, n))

    def walk(o):
        if o is None:
            out.append(0xC0)
        elif o is True or o is False:
            out.append(0xC3 if o else 0xC2)
        elif isinstance(o, int):
            if -32 <= o < 128:
                out.extend(struct.pack(">b", o) if o < 0 else bytes([o]))
                return
            for code, fmt, low, top in _MP_INTS:
                if low <= o < top:
                    out.append(code)
                    out.extend(struct.pack(fmt, o))
                    return
            raise OverflowError(f"int {o} out of msgpack range")
        elif isinstance(o, float):
            out.extend(struct.pack(">Bd", 0xCB, o))
        elif isinstance(o, str):
            b = o.encode()
            head(len(b), 0xA0, 31, 0xD9, 0xDA, 0xDB)
            out.extend(b)
        elif isinstance(o, list):
            head(len(o), 0x90, 15, None, 0xDC, 0xDD)
            for v in o:
                walk(v)
        elif isinstance(o, dict):
            head(len(o), 0x80, 15, None, 0xDE, 0xDF)
            for k, v in o.items():
                walk(k)
                walk(v)
        else:
            raise TypeError(f"cannot msgpack {type(o)!r}")

    walk(obj)
    return bytes(out)


def _mp_unpack(data: bytes, hook: Callable[[dict], Any]) -> Any:
    """Decode one msgpack object; `hook` maps each decoded map, inner
    maps first (msgpack's `object_hook`)."""
    pos = 0

    def take(fmt: str):
        nonlocal pos
        vals = struct.unpack_from(fmt, data, pos)
        pos += struct.calcsize(fmt)
        return vals[0]

    def raw(n: int) -> bytes:
        nonlocal pos
        pos += n
        return data[pos - n:pos]

    def container(n: int, is_map: bool):
        if is_map:
            m = {}
            for _ in range(n):
                k = walk()
                m[k] = walk()
            return hook(m)
        return [walk() for _ in range(n)]

    fixed = {0xC0: None, 0xC2: False, 0xC3: True}
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}

    def walk():
        code = take(">B")
        if code < 0x80:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return container(code & 0x0F, True)
        if 0x90 <= code <= 0x9F:
            return container(code & 0x0F, False)
        if 0xA0 <= code <= 0xBF:
            return raw(code & 0x1F).decode()
        if code in fixed:
            return fixed[code]
        if code in ints:
            return take(ints[code])
        if code in (0xD9, 0xDA, 0xDB):
            return raw(take({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[code])).decode()
        if code in (0xC4, 0xC5, 0xC6):
            return bytes(raw(take({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[code])))
        if code in (0xDC, 0xDD):
            return container(take(">H" if code == 0xDC else ">I"), False)
        if code in (0xDE, 0xDF):
            return container(take(">H" if code == 0xDE else ">I"), True)
        raise ValueError(f"unsupported msgpack type byte 0x{code:02x}")

    obj = walk()
    if pos != len(data):
        raise ValueError("trailing bytes after the msgpack header")
    return obj
