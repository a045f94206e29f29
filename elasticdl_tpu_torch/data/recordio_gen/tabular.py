"""Tabular (libfm/CSV) datasets -> RecordIO shards.

The reference's frappe converter (`elasticdl_tpu/data/recordio_gen/
tabular.py`), writing the same shard bytes over the port's record codec
and RecordIO writer: parse LOCAL libfm or CSV files, remap the raw
feature ids to a dense 1-based vocabulary (0 pads), pad every row to the
longest, and write the model zoo's fixed-layout tabular records (int64
ids + float32 label: what `deepfm_edl_embedding`'s dataset_fn decodes),
plus `meta.json` with the vocabulary size and row length.

CLI:
  python -m elasticdl_tpu_torch.data.recordio_gen.tabular OUT_DIR \
      --train train.libfm --test test.libfm --records_per_shard 16384
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.data.recordio import RecordIOWriter
from elasticdl_tpu_torch.models.record_codec import encode_tabular_record

logger = get_logger(__name__)


def read_libfm(path: str) -> Tuple[List[List[int]], List[float]]:
    """libfm lines: `label idx:val idx:val ...` (values ignored — the
    Frappe features are one-hot, reference frappe_recordio_gen.py)."""
    rows, labels = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            labels.append(max(float(parts[0]), 0.0))  # -1/1 -> 0/1
            rows.append([int(p.partition(":")[0]) for p in parts[1:]])
    return rows, labels


def read_csv(path: str, label_column: int = -1) -> Tuple[List[List[int]], List[float]]:
    """CSV of integer categorical columns + one label column."""
    rows, labels = [], []
    with open(path) as f:
        for line in f:
            cells = [c.strip() for c in line.split(",") if c.strip() != ""]
            if not cells:
                continue
            labels.append(float(cells[label_column]))
            del cells[label_column]
            rows.append([int(float(c)) for c in cells])
    return rows, labels


def build_feature_map(rowsets: Iterable[List[List[int]]]) -> Dict[int, int]:
    """Dense remap of every raw feature id, 1-based (0 = padding) —
    reference gen_feature_map."""
    fmap: Dict[int, int] = {}
    for rows in rowsets:
        for row in rows:
            for raw in row:
                if raw not in fmap:
                    fmap[raw] = len(fmap) + 1
    return fmap


def convert_split(
    rows: List[List[int]],
    labels: List[float],
    fmap: Dict[int, int],
    maxlen: int,
    out_dir: str,
    subdir: str,
    records_per_shard: int = 16 * 1024,
) -> list:
    target = os.path.join(out_dir, subdir)
    os.makedirs(target, exist_ok=True)
    paths: list = []
    writer = None
    try:
        for i, (row, label) in enumerate(zip(rows, labels)):
            if i % records_per_shard == 0:
                if writer:
                    writer.close()
                path = os.path.join(target, "data-%05d" % len(paths))
                logger.info("Writing %s ...", path)
                writer = RecordIOWriter(path)
                paths.append(path)
            ids = np.zeros(maxlen, dtype=np.int64)
            mapped = [fmap[r] for r in row]
            ids[: len(mapped)] = mapped
            writer.write(encode_tabular_record(ids, label))
    finally:
        if writer:
            writer.close()
    logger.info("Wrote %d records into %d shards", len(rows), len(paths))
    return paths


def main(argv: Optional[Iterable[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert libfm/CSV tabular data into RecordIO shards"
    )
    parser.add_argument("dir", help="output directory")
    parser.add_argument("--train", required=True)
    parser.add_argument("--validation", default="")
    parser.add_argument("--test", default="")
    parser.add_argument("--format", choices=("libfm", "csv"), default="libfm")
    parser.add_argument("--records_per_shard", type=int, default=16 * 1024)
    args = parser.parse_args(argv)

    reader = read_libfm if args.format == "libfm" else read_csv
    splits = {"train": reader(args.train)}
    if args.validation:
        splits["validation"] = reader(args.validation)
    if args.test:
        splits["test"] = reader(args.test)

    fmap = build_feature_map([rows for rows, _ in splits.values()])
    maxlen = max(len(r) for rows, _ in splits.values() for r in rows)
    logger.info("feature_num=%d maxlen=%d", len(fmap), maxlen)
    for name, (rows, labels) in splits.items():
        convert_split(
            rows, labels, fmap, maxlen, args.dir, name, args.records_per_shard
        )
    # the embedding layer needs the vocabulary size at model-build time
    with open(os.path.join(args.dir, "meta.json"), "w") as f:
        json.dump({"feature_num": len(fmap), "maxlen": maxlen}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
