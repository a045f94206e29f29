"""Synthetic RecordIO shard generator (hermetic dev/CI data).

The reference's generator (`elasticdl_tpu/data/recordio_gen/
synthetic.py`): LEARNABLE synthetic image records (class-dependent
means, the generator the benches' convergence gates train on,
`models/record_codec.py`), the same shard bytes as the reference's for
the same flags, so a zero-egress environment has data.

    python -m elasticdl_tpu_torch.data.recordio_gen.synthetic \
        --out /data/mnist --shape 28,28,1 --classes 10 \
        --records 16384 --records_per_shard 4096
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--shape", default="28,28,1", help="H,W,C")
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--records", type=int, default=16384)
    p.add_argument("--records_per_shard", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from elasticdl_tpu_torch.models.record_codec import (
        write_synthetic_image_records,
    )

    shape = tuple(int(d) for d in args.shape.split(","))
    os.makedirs(args.out, exist_ok=True)
    n_shards = max(1, -(-args.records // args.records_per_shard))
    written = 0
    for i in range(n_shards):
        n = min(args.records_per_shard, args.records - written)
        write_synthetic_image_records(
            os.path.join(args.out, f"shard-{i:04d}.rio"),
            n,
            shape,
            args.classes,
            seed=args.seed + i,
        )
        written += n
    print(f"wrote {written} records in {n_shards} shards to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
