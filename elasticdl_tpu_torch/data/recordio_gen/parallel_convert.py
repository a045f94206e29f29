"""Parallel raw-file -> RecordIO conversion.

The reference's converter (`elasticdl_tpu/data/recordio_gen/
parallel_convert.py`): the input files are cut into shards of
`records_per_shard` files, and a process pool runs a user module's
`prepare_data_for_a_single_file(file_object, filename)` over each
shard's files, writing one RecordIO shard `data-NNNNN` each. A prep
function returns one record (bytes), or a list of records, which are
written in order: the zoo's ImageNet prep
(`models/imagenet_resnet50.py`) turns one tar of `.npy` images into a
list of image records. The pool's processes are spawned, not forked.

CLI:
  python -m elasticdl_tpu_torch.data.recordio_gen.parallel_convert OUT_DIR \\
      --input 'raw/*.tar' --prep_module prep.py --num_workers 8
"""

from __future__ import annotations

import argparse
import glob
import multiprocessing
import os
import sys
from typing import Iterable, List, Optional

from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.data.recordio import RecordIOWriter

logger = get_logger(__name__)


def _convert_partition(job) -> str:
    """One worker: run the user prep fn over its files, write one shard."""
    files, prep_path, out_path = job
    from elasticdl_tpu_torch.api.model_spec import load_module

    prep = load_module(prep_path).prepare_data_for_a_single_file
    n = 0
    with RecordIOWriter(out_path) as w:
        for path in files:
            with open(path, "rb") as f:
                out = prep(f, path)
            for record in out if isinstance(out, (list, tuple)) else (out,):
                w.write(record)
                n += 1
    logger.info("Wrote %d records of %d files -> %s", n, len(files), out_path)
    return out_path


def convert_files(
    files: List[str],
    prep_module: str,
    out_dir: str,
    records_per_shard: int = 16 * 1024,
    num_workers: int = os.cpu_count() or 1,
) -> List[str]:
    """Partition `files` into shards of `records_per_shard` files and
    convert them on a process pool. Returns the shard paths."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = [
        (files[start : start + records_per_shard], prep_module,
         os.path.join(out_dir, "data-%05d" % shard))
        for shard, start in enumerate(range(0, len(files), records_per_shard))
    ]
    if num_workers <= 1 or len(jobs) == 1:
        return [_convert_partition(j) for j in jobs]
    with multiprocessing.get_context("spawn").Pool(min(num_workers, len(jobs))) as pool:
        return list(pool.map(_convert_partition, jobs))


def main(argv: Optional[Iterable[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert raw files into RecordIO shards in parallel"
    )
    parser.add_argument("dir", help="output directory")
    parser.add_argument("--input", required=True, help="glob of raw files")
    parser.add_argument(
        "--prep_module", required=True,
        help="python file defining prepare_data_for_a_single_file(f, name)",
    )
    parser.add_argument("--records_per_shard", type=int, default=16 * 1024)
    parser.add_argument("--num_workers", type=int, default=os.cpu_count() or 1)
    args = parser.parse_args(argv)
    files = sorted(glob.glob(args.input))
    if not files:
        logger.error("no files match %r", args.input)
        return 1
    convert_files(files, args.prep_module, args.dir, args.records_per_shard, args.num_workers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
