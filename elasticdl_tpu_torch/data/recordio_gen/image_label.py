"""Image datasets -> RecordIO shards.

The reference's converter (`elasticdl_tpu/data/recordio_gen/
image_label.py`), writing the same shard bytes over the port's record
codec and RecordIO writer:

- records use the model zoo's fixed-layout byte codec
  (`record_codec.encode_image_record`: int64 label + raw uint8 pixels —
  4x smaller than float protos and decodable with one `np.frombuffer`);
- datasets load from LOCAL files in their standard on-disk formats:
  MNIST IDX (`train-images-idx3-ubyte[.gz]`) and the CIFAR-10 python
  pickle batches (`cifar-10-batches-py/`), or from in-memory numpy
  arrays (`convert`) for anything else.

CLI:
  python -m elasticdl_tpu_torch.data.recordio_gen.image_label OUT_DIR \
      --dataset mnist --source /path/to/idx_files \
      --records_per_shard 16384 --fraction 1.0
"""

from __future__ import annotations

import argparse
import gzip
import os
import pickle
import sys
import tarfile
from typing import Iterable, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.data.recordio import RecordIOWriter
from elasticdl_tpu_torch.models.record_codec import encode_image_record

logger = get_logger(__name__)


def convert(
    x: np.ndarray,
    y: np.ndarray,
    out_dir: str,
    subdir: str,
    records_per_shard: int = 16 * 1024,
    fraction: float = 1.0,
) -> list:
    """(images, labels) arrays -> `out_dir/subdir/data-NNNNN` shards
    (reference image_label.py:12-58). Returns the shard paths."""
    n = int(x.shape[0] * fraction)
    target = os.path.join(out_dir, subdir)
    os.makedirs(target, exist_ok=True)
    if x.ndim == 3:  # grayscale -> add channel axis
        x = x[..., None]
    y = np.asarray(y).reshape(-1)
    paths = []
    writer = None
    try:
        for row in range(n):
            if row % records_per_shard == 0:
                if writer:
                    writer.close()
                path = os.path.join(target, "data-%05d" % len(paths))
                logger.info("Writing %s ...", path)
                writer = RecordIOWriter(path)
                paths.append(path)
            writer.write(encode_image_record(x[row], int(y[row])))
    finally:
        if writer:
            writer.close()
    logger.info("Wrote %d of %d records into %d shards", n, x.shape[0], len(paths))
    return paths


# ------------------------------------------------------- local-file loaders


def _open_maybe_gz(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _read_idx(path: str) -> np.ndarray:
    """MNIST IDX format: magic int32 (dtype+ndim), dims, raw bytes."""
    with _open_maybe_gz(path) as f:
        magic = int.from_bytes(f.read(4), "big")
        ndim = magic & 0xFF
        dims = [int.from_bytes(f.read(4), "big") for _ in range(ndim)]
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find(source: str, *candidates: str) -> str:
    for name in candidates:
        for suffix in ("", ".gz"):
            path = os.path.join(source, name + suffix)
            if os.path.exists(path):
                return path
    raise FileNotFoundError(f"none of {candidates} under {source}")


def load_mnist(source: str):
    """-> ((x_train, y_train), (x_test, y_test)) from IDX files."""
    return (
        (
            _read_idx(_find(source, "train-images-idx3-ubyte")),
            _read_idx(_find(source, "train-labels-idx1-ubyte")),
        ),
        (
            _read_idx(_find(source, "t10k-images-idx3-ubyte")),
            _read_idx(_find(source, "t10k-labels-idx1-ubyte")),
        ),
    )


def _cifar_batch(raw: dict) -> Tuple[np.ndarray, np.ndarray]:
    data = raw[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return data, np.asarray(raw[b"labels"], dtype=np.int64)


def load_cifar10(source: str):
    """-> ((x_train, y_train), (x_test, y_test)) from the python
    pickle batches (dir `cifar-10-batches-py/` or the .tar.gz)."""
    batch_dir = source
    if os.path.isdir(os.path.join(source, "cifar-10-batches-py")):
        batch_dir = os.path.join(source, "cifar-10-batches-py")
    if os.path.isfile(source) and source.endswith((".tar.gz", ".tgz")):
        with tarfile.open(source) as tar:
            tmp = os.path.join(os.path.dirname(source), "_cifar_extract")
            tar.extractall(tmp)
            batch_dir = os.path.join(tmp, "cifar-10-batches-py")

    def load(name):
        with open(os.path.join(batch_dir, name), "rb") as f:
            return _cifar_batch(pickle.load(f, encoding="bytes"))

    xs, ys = zip(*[load(f"data_batch_{i}") for i in range(1, 6)])
    x_test, y_test = load("test_batch")
    return (np.concatenate(xs), np.concatenate(ys)), (x_test, y_test)


LOADERS = {"mnist": load_mnist, "cifar10": load_cifar10}


def main(argv: Optional[Iterable[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert image datasets into RecordIO shards"
    )
    parser.add_argument("dir", help="output directory")
    parser.add_argument("--dataset", choices=sorted(LOADERS), default="mnist")
    parser.add_argument(
        "--source", required=True,
        help="local dataset files (IDX dir for mnist, pickle batches "
        "dir / tarball for cifar10) — this environment is zero-egress",
    )
    parser.add_argument("--records_per_shard", type=int, default=16 * 1024)
    parser.add_argument("--fraction", type=float, default=1.0)
    args = parser.parse_args(argv)
    (x_train, y_train), (x_test, y_test) = LOADERS[args.dataset](args.source)
    out = os.path.join(args.dir, args.dataset)
    convert(x_train, y_train, out, "train", args.records_per_shard, args.fraction)
    convert(x_test, y_test, out, "test", args.records_per_shard, args.fraction)
    return 0


if __name__ == "__main__":
    sys.exit(main())
