"""The port's sharded ingestion (``data/shards.py``) against the JAX
package's, on the CPU.

The same records give byte-identical shard files and index in both
packages; a shard set written by either reads in the other, item for item;
``pack_dataset`` over a WHAM loader gives back its items bit for bit (and
JAX's files); and the threaded loader runs over a shard set with a
``device_put_fn``.
"""

import os

import numpy as np
import pytest
import torch

from sudo_rm_rf_tpu.data import shards as jshards
from sudo_rm_rf_tpu.data.wham import WhamDataset as JWham
from sudo_rm_rf_tpu_torch.data import ShardedDataset, pack_dataset, write_shards
from sudo_rm_rf_tpu_torch.data.synthetic import write_wham_corpus
from sudo_rm_rf_tpu_torch.data.wham import WhamDataset
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)


def _records(n=7, seed=0):
    """Records of three fields; the source count varies, as FUSS's does."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        yield (rng.standard_normal(300).astype(np.float32),
               rng.standard_normal((1 + i % 3, 300)).astype(np.float32),
               np.array([i], np.int64))


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("target_shard_bytes", [1, 4000, 2**20])
def test_shards_are_byte_identical_to_jax(tmp_path, target_shard_bytes):
    schema = [("mixture", "float32"), ("sources", "float32"), ("index", "int64")]
    got = write_shards(_records(), str(tmp_path / "port"), name="c", schema=schema,
                       target_shard_bytes=target_shard_bytes)
    want = jshards.write_shards(_records(), str(tmp_path / "jax"), name="c", schema=schema,
                                target_shard_bytes=target_shard_bytes)
    assert os.path.basename(got) == os.path.basename(want) == "c.index.json"
    got_files, want_files = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got_files == want_files
    n_shards = sum(f.endswith(".bin") for f in got_files)
    assert n_shards == {1: 7, 4000: 5, 2**20: 1}[target_shard_bytes]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_shards(tmp_path, writer):
    write = write_shards if writer == "port" else jshards.write_shards
    index = write(_records(), str(tmp_path), target_shard_bytes=4000)
    got, want = ShardedDataset(index), jshards.ShardedDataset(index)
    records = list(_records())
    assert len(got) == len(want) == len(records)
    assert [(n, str(d)) for n, d in got.schema] == [("field0", "float32"),
                                                   ("field1", "float32"), ("field2", "int64")]
    for i, rec in enumerate(records):
        for g, w, r in zip(got[i], want[i], rec):
            assert g.dtype == w.dtype == r.dtype and g.shape == w.shape == r.shape
            np.testing.assert_array_equal(g, r)
            np.testing.assert_array_equal(w, r)
    got.close()


def test_shards_refuse_a_record_off_the_schema(tmp_path):
    recs = [(np.zeros(3, np.float32),), (np.zeros(3, np.float64),)]
    with pytest.raises(ValueError, match="dtype float64 != schema float32"):
        write_shards(recs, str(tmp_path))
    with pytest.raises(ValueError, match="arity"):
        write_shards([(np.zeros(3, np.float32),), (np.zeros(3, np.float32),) * 2],
                     str(tmp_path))


@pytest.fixture(scope="module")
def wham_root(tmp_path_factory):
    return write_wham_corpus(str(tmp_path_factory.mktemp("wham")), n_train=4, n_val=2,
                             seconds=0.5, seed=3)


def test_pack_dataset_over_a_wham_loader(tmp_path, wham_root):
    kw = dict(root_dirpath=wham_root, task="sep_clean", min_or_max="min",
              split="cv", sample_rate=8000, timelength=0.25, zero_pad=True, augment=False,
              normalize_audio=False)
    ds = WhamDataset(**kw)
    index = pack_dataset(ds, str(tmp_path / "port"))
    jshards.pack_dataset(JWham(**kw), str(tmp_path / "jax"))
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    packed = ShardedDataset(index)
    assert len(packed) == len(ds) == 2
    for i in range(len(ds)):
        for g, w in zip(packed[i], ds[i]):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_loader_runs_over_shards_with_a_device_put_fn(tmp_path):
    # one source a record, so that the items stack
    index = write_shards(((m, s[:1], i) for m, s, i in _records(n=6)), str(tmp_path),
                         target_shard_bytes=4000)
    ds = ShardedDataset(index)
    seen = []

    def device_put(batch):
        seen.append(len(batch))
        return tuple(torch.from_numpy(np.array(x)) for x in batch)

    gen = ds.get_generator(batch_size=4, shuffle=False, num_workers=2, drop_last=False,
                           device_put_fn=device_put)
    batches = list(gen)
    assert len(gen) == len(batches) == 2 and seen == [3, 3]
    assert all(isinstance(x, torch.Tensor) for b in batches for x in b)
    order = torch.cat([b[2][:, 0] for b in batches]).tolist()
    assert order == list(range(6))
    np.testing.assert_array_equal(batches[1][0].numpy(), np.stack([ds[4][0], ds[5][0]]))


def test_sharded_reads_from_many_threads(tmp_path):
    """Items read from more threads than cores, switching often, each shard
    opened once: every reader holds the file it reads (a file dropped by a
    racing open closed its descriptor under another reader)."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    records = list(_records(n=40))
    ds = ShardedDataset(write_shards(records, str(tmp_path), target_shard_bytes=4000))
    order = list(range(len(records))) * 5
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=4 * (os.cpu_count() or 4)) as pool:
            got = list(pool.map(ds.__getitem__, order, timeout=60))
    finally:
        sys.setswitchinterval(interval)
    for i, item in zip(order, got):
        np.testing.assert_array_equal(item[1], records[i][1])
    assert len(ds._files) == len({r[0] for r in ds.records})
    ds.close()


def test_loader_raises_what_its_producer_raises(tmp_path):
    """An item that fails to read is raised by the loader's iterator."""
    index = write_shards(((m, s[:1], i) for m, s, i in _records(n=4)), str(tmp_path))
    ds = ShardedDataset(index)
    os.remove(os.path.join(str(tmp_path), "data.shard-00000.bin"))
    with pytest.raises(FileNotFoundError):
        list(ds.get_generator(batch_size=2, shuffle=False, num_workers=2))
