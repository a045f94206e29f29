"""The port's RecordIO converters
(`elasticdl_tpu_torch/data/recordio_gen/`) against the reference's:

- `parallel_convert` with the zoo's ImageNet prep
  (`models/imagenet_resnet50.py`) over tars of `<label>/<n>.npy` images
  writes, shard for shard, the bytes that the reference's RecordIO writer
  writes for the reference prep's records in the same partition (the
  reference's `parallel_convert` writes one record a file and refuses
  the list that its own ImageNet prep returns, so its writer is fed here
  with that prep's output); with a prep that returns one record a file,
  the shards equal the reference converter's own, byte for byte;
- `image_label`'s loaders and `convert` (tiny MNIST IDX files, gzipped,
  and CIFAR-10 pickle batches made here) and its CLI, and `synthetic`'s
  CLI, write the reference's shard bytes.
"""

import gzip
import io
import os
import pickle
import tarfile

import numpy as np
import pytest

from elasticdl_tpu.data.recordio import RecordIOWriter as JWriter
from elasticdl_tpu.data.recordio_gen import image_label as jimage_label
from elasticdl_tpu.data.recordio_gen import parallel_convert as jparallel
from elasticdl_tpu.data.recordio_gen import synthetic as jsynthetic
from elasticdl_tpu.models import imagenet_resnet50 as jimagenet
from elasticdl_tpu_torch.data.recordio import count_records
from elasticdl_tpu_torch.data.recordio_gen import image_label, parallel_convert, synthetic
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREP = os.path.join(REPO, "elasticdl_tpu_torch", "models", "imagenet_resnet50.py")


def _tree_bytes(d):
    out = {}
    for root, _dirs, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def _write_tars(raw, n_tars, per_tar, seed=0, shape=(8, 8, 3)):
    rng = np.random.default_rng(seed)
    paths = []
    for t in range(n_tars):
        path = os.path.join(raw, f"part-{t}.tar")
        with tarfile.open(path, "w") as tar:
            for i in range(per_tar):
                buf = io.BytesIO()
                np.save(buf, rng.integers(0, 256, shape, dtype=np.uint8))
                info = tarfile.TarInfo(f"{int(rng.integers(0, 10))}/{i}.npy")
                info.size = buf.tell()
                buf.seek(0)
                tar.addfile(info, buf)
        paths.append(path)
    return paths


@pytest.mark.parametrize("num_workers", [1, 2])
def test_imagenet_tars_convert_to_the_references_shard_bytes(tmp_path, num_workers):
    raw = str(tmp_path / "raw")
    os.makedirs(raw)
    tars = _write_tars(raw, 5, 6)
    out = str(tmp_path / "port")
    paths = parallel_convert.convert_files(tars, PREP, out, records_per_shard=2,
                                           num_workers=num_workers)
    assert [os.path.basename(p) for p in paths] == ["data-00000", "data-00001", "data-00002"]
    assert [count_records(p) for p in paths] == [12, 12, 6]
    # the reference's writer over the reference prep's records, same partition
    ref = str(tmp_path / "ref")
    os.makedirs(ref)
    for shard, start in enumerate(range(0, len(tars), 2)):
        with JWriter(os.path.join(ref, "data-%05d" % shard)) as w:
            for path in tars[start:start + 2]:
                with open(path, "rb") as f:
                    for record in jimagenet.prepare_data_for_a_single_file(f, path):
                        w.write(record)
    assert _tree_bytes(out) == _tree_bytes(ref)


def test_one_record_a_file_prep_equals_the_reference_converter(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    for i in range(7):
        (raw / f"f{i:02d}.bin").write_bytes(bytes(range(i, i + 40)))
    prep = tmp_path / "prep.py"
    prep.write_text("def prepare_data_for_a_single_file(f, name):\n    return f.read()[::-1]\n")
    rc = parallel_convert.main([str(tmp_path / "port"), "--input", str(raw / "*.bin"),
                                "--prep_module", str(prep), "--records_per_shard", "3",
                                "--num_workers", "2"])
    assert rc == 0
    assert jparallel.main([str(tmp_path / "ref"), "--input", str(raw / "*.bin"),
                           "--prep_module", str(prep), "--records_per_shard", "3",
                           "--num_workers", "1"]) == 0
    got, want = _tree_bytes(str(tmp_path / "port")), _tree_bytes(str(tmp_path / "ref"))
    assert sorted(got) == ["data-00000", "data-00001", "data-00002"] and got == want
    assert parallel_convert.main([str(tmp_path / "none"), "--input", str(raw / "*.nope"),
                                  "--prep_module", str(prep)]) == 1


def _idx(path, arr, gz):
    header = (0x08 << 8 | arr.ndim).to_bytes(4, "big") + b"".join(
        d.to_bytes(4, "big") for d in arr.shape)
    data = header + arr.astype(np.uint8).tobytes()
    with (gzip.open(path + ".gz", "wb") if gz else open(path, "wb")) as f:
        f.write(data)


def test_image_label_mnist_and_cifar_equal_the_references(tmp_path):
    rng = np.random.default_rng(5)
    mnist = tmp_path / "mnist"
    mnist.mkdir()
    for name, arr, gz in (("train-images-idx3-ubyte", rng.integers(0, 256, (11, 28, 28)), True),
                          ("train-labels-idx1-ubyte", rng.integers(0, 10, 11), False),
                          ("t10k-images-idx3-ubyte", rng.integers(0, 256, (5, 28, 28)), False),
                          ("t10k-labels-idx1-ubyte", rng.integers(0, 10, 5), True)):
        _idx(str(mnist / name), arr, gz)
    cifar = tmp_path / "cifar" / "cifar-10-batches-py"
    cifar.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(cifar / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (3, 3072), dtype=np.uint8),
                         b"labels": [int(x) for x in rng.integers(0, 10, 3)]}, f)
    for ds, src in (("mnist", mnist), ("cifar10", tmp_path / "cifar")):
        got_arrays = image_label.LOADERS[ds](str(src))
        want_arrays = jimage_label.LOADERS[ds](str(src))
        for g, w in zip(np.concatenate([a.reshape(-1) for pair in got_arrays for a in pair]),
                        np.concatenate([a.reshape(-1) for pair in want_arrays for a in pair])):
            assert g == w
        argv = ["--dataset", ds, "--source", str(src), "--records_per_shard", "4",
                "--fraction", "0.8"]
        assert image_label.main([str(tmp_path / "port")] + argv) == 0
        assert jimage_label.main([str(tmp_path / "ref")] + argv) == 0
    got, want = _tree_bytes(str(tmp_path / "port")), _tree_bytes(str(tmp_path / "ref"))
    assert len(got) == 7 and got == want  # mnist 2 + 1 shards, cifar10 3 + 1


def test_synthetic_cli_equals_the_references(tmp_path):
    argv = ["--shape", "6,6,3", "--classes", "4", "--records", "21", "--records_per_shard", "8",
            "--seed", "3"]
    assert synthetic.main(["--out", str(tmp_path / "port")] + argv) == 0
    assert jsynthetic.main(["--out", str(tmp_path / "ref")] + argv) == 0
    got, want = _tree_bytes(str(tmp_path / "port")), _tree_bytes(str(tmp_path / "ref"))
    assert sorted(got) == ["shard-0000.rio", "shard-0001.rio", "shard-0002.rio"] and got == want
