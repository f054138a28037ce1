"""The port's data layer and bookkeeping against the JAX package's, on the CPU.

A small WHAM-layout (and Libri2Mix-layout) directory of wavs of odd lengths;
both packages' datasets and loaders must yield the same arrays in the same
order (exactly: the code paths are copies over numpy).
"""

import os
import pickle

import numpy as np
import pytest
from scipy.io import wavfile

from sudo_rm_rf_tpu import config as jconfig
from sudo_rm_rf_tpu.data import base as jbase
from sudo_rm_rf_tpu.data import setup as jsetup
from sudo_rm_rf_tpu.data.libri2mix import LibriMixDataset as JLibriMix
from sudo_rm_rf_tpu.data.wham import WhamDataset as JWham
from sudo_rm_rf_tpu.utils import logging as jlogging
from sudo_rm_rf_tpu_torch import config as tconfig
from sudo_rm_rf_tpu_torch.data import base as tbase
from sudo_rm_rf_tpu_torch.data import setup as tsetup
from sudo_rm_rf_tpu_torch.data.libri2mix import LibriMixDataset
from sudo_rm_rf_tpu_torch.data.synthetic import write_wham_corpus
from sudo_rm_rf_tpu_torch.data.wham import WhamDataset
from sudo_rm_rf_tpu_torch.utils import logging as tlogging
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

SR = 8000


def _write_split(base, dirs, n_files, seed):
    rng = np.random.default_rng(seed)
    for d in dirs:
        os.makedirs(os.path.join(base, d), exist_ok=True)
    for i in range(n_files):
        n = int(rng.integers(SR // 2, SR + 700))  # some shorter than 1 s
        for d in dirs:
            wav = (rng.standard_normal(n) * 5000).astype(np.int16)
            wavfile.write(os.path.join(base, d, f"f{i:03d}.wav"), SR, wav)


@pytest.fixture(scope="module")
def wham_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wham"))
    for split, n in (("tr", 7), ("cv", 5), ("tt", 3)):
        _write_split(os.path.join(root, "wav8k", "min", split),
                     ("mix_clean", "s1", "s2", "mix_both", "noise"), n, len(split) + n)
    return root


@pytest.fixture(scope="module")
def libri_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("libri"))
    for split, n in (("train-100", 6), ("dev", 4)):
        _write_split(os.path.join(root, "wav8k", "min", split),
                     ("mix_clean", "s1", "s2"), n, len(split))
    return root


def _wham_kwargs(root, **kw):
    base = dict(root_dirpath=root, task="sep_clean", split="tr", min_or_max="min",
                augment=True, normalize_audio=False, sample_rate=SR, timelength=0.75,
                zero_pad=True, n_samples=0, seed=3)
    base.update(kw)
    return base


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(normalize_audio=True),
    dict(augment=False, split="cv", task="sep_noisy"),
    dict(zero_pad=False, timelength=0.5, n_samples=4),
])
def test_wham_dataset_matches_jax(wham_root, kw):
    got, want = WhamDataset(**_wham_kwargs(wham_root, **kw)), JWham(**_wham_kwargs(wham_root, **kw))
    assert got.file_names == want.file_names and len(got) == len(want)
    for epoch in (0, 2):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for i in range(len(got)):
            _assert_items_equal(got[i], want[i])


def test_wham_crops_move_with_the_epoch(wham_root):
    ds = WhamDataset(**_wham_kwargs(wham_root, timelength=0.25))
    first = ds[0][0]
    ds.set_epoch(1)
    assert not np.array_equal(first, ds[0][0])


@pytest.mark.parametrize("shuffle", [True, False])
def test_dataloader_yields_jax_batches_in_order(wham_root, shuffle):
    got = WhamDataset(**_wham_kwargs(wham_root)).get_generator(
        batch_size=2, shuffle=shuffle, num_workers=3, seed=5)
    want = JWham(**_wham_kwargs(wham_root)).get_generator(
        batch_size=2, shuffle=shuffle, num_workers=3, seed=5)
    assert len(got) == len(want) == 3  # 7 files, drop_last
    for _ in range(2):  # two epochs: the shuffle moves with the epoch
        batches = list(got)
        for a, b in zip(batches, list(want)):
            _assert_items_equal(a, b)
        assert len(batches) == 3 and batches[0][1].shape == (2, 2, 6000)


def test_length_metadata_cache_is_shared(tmp_path):
    _write_split(str(tmp_path), ("mix_clean",), 3, 1)
    wavs = [str(p) for p in (tmp_path / "mix_clean").glob("*.wav")]
    got = tbase.length_metadata(str(tmp_path), wavs)
    with open(tmp_path / "metadata", "rb") as fh:
        assert pickle.load(fh) == got
    os.remove(tmp_path / "metadata")
    assert jbase.length_metadata(str(tmp_path), wavs) == got
    # the JAX package's cache file is read back by the port
    assert tbase.length_metadata(str(tmp_path), []) == got


def test_base_helpers_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 50)).astype(np.float32)
    np.testing.assert_array_equal(tbase.normalize_wav(x), jbase.normalize_wav(x))
    np.testing.assert_array_equal(tbase.normalize_wav(x, std=2.0), jbase.normalize_wav(x, std=2.0))
    for n, pad in ((80, True), (30, True), (30, False)):
        np.testing.assert_array_equal(tbase.safe_pad(x, n, pad), jbase.safe_pad(x, n, pad))
    kwargs = {"a": 3, "b": "x"}
    assert tbase.check_arg(kwargs, "a", int) == 3
    assert tbase.check_arg(kwargs, "c", int, default=7) == 7
    for args in (("c", int), ("a", str), ("b", str, ["y"])):
        with pytest.raises(tbase.DatasetConfigError):
            tbase.check_arg(kwargs, *args)
        with pytest.raises(jbase.DatasetConfigError):
            jbase.check_arg(kwargs, *args)


@pytest.mark.parametrize("split", ["train-100", "dev"])
def test_librimix_dataset_matches_jax(libri_root, split):
    kw = dict(root_dirpath=libri_root, task="sep_clean", split=split, min_or_max="min",
              normalize_audio=split == "dev", sample_rate=SR, timelength=0.75,
              zero_pad=True)
    got, want = LibriMixDataset(**kw), JLibriMix(**kw)
    assert got.file_names == want.file_names
    for i in range(len(got)):
        _assert_items_equal(got[i], want[i])


@pytest.mark.parametrize("dataset", ["WHAM", "LIBRI2MIX"])
def test_setup_matches_jax(wham_root, libri_root, dataset):
    hp = dict(tconfig.ExperimentConfig().hparams(), train=[dataset], val=[dataset],
              test=[], train_val=[], batch_size=2, n_jobs=2, audio_timelength=0.5,
              wham_root=wham_root, libri2mix_root=libri_root)
    got, want = tsetup.setup(hp), jsetup.setup(hp)
    assert sorted(k for k, v in got.items() if v) == ["train", "val"]
    for split in ("train", "val"):
        assert len(got[split]) == len(want[split])
        assert got[split].shuffle == want[split].shuffle == (split == "train")
        for a, b in zip(got[split], want[split]):
            _assert_items_equal(a, b)


@pytest.mark.parametrize("name", ["MUSDB"])
def test_setup_raises_for_datasets_that_wait(name, tmp_path, monkeypatch):
    """No dataset of the JAX package waits since MUSDB was ported: its setup
    now reaches the loader, which raises for a root without tracks as JAX's
    does, and a name neither package knows raises JAX's ValueError."""
    monkeypatch.setenv("SUDO_TPU_MUSDB8K_ROOT", str(tmp_path))
    hp = dict(tconfig.ExperimentConfig().hparams(), train=[name], val=[])
    for setup in (tsetup.setup, jsetup.setup):
        with pytest.raises(ValueError, match="no musdb track dirs"):
            setup(hp)
    with pytest.raises(ValueError, match="NOSUCH is not yet supported"):
        tsetup.setup(dict(hp, train=["NOSUCH"]))


def test_setup_loads_augmented_datasets(tmp_path):
    """An AUGMENTED_* name loads its hierarchical roots (it waited until the
    hierarchical loader was ported); a split without roots gets no generator,
    as in JAX."""
    from sudo_rm_rf_tpu_torch.data.synthetic import write_hierarchical_corpus

    root = write_hierarchical_corpus(str(tmp_path), 3, 0, 0, 2, 0, seconds=0.5)
    hp = dict(tconfig.ExperimentConfig().hparams(), train=["AUGMENTED_WSJMIX"],
              val=["AUGMENTED_WSJMIX"], n_train=4, batch_size=2, audio_timelength=0.25,
              train_dataset_paths=[os.path.join(root, "train")])
    gens = tsetup.setup(hp)
    assert gens["val"] is None and len(gens["train"]) == 2
    mixture, sources = next(iter(gens["train"]))
    assert mixture.shape == (2, 2000) and sources.shape == (2, 2, 2000)


def test_config_tree_matches_jax():
    got, want = tconfig.ExperimentConfig().hparams(), jconfig.ExperimentConfig().hparams()
    assert got == want
    model = tconfig.ModelConfig(out_channels=16, in_channels=32, num_blocks=1,
                                upsampling_depth=2, enc_num_basis=16).build()
    assert type(model).__name__ == "SuDORMRFImproved"
    assert all(b.block_impl == "fma" for b in model.sm)  # the training default


def test_report_and_logger_match_jax(tmp_path):
    acc = {"tr_loss": {"acc": [1.0, 2.0, 4.0]}, "val_SISDRi": {"acc": [0.5, -0.5]}}
    got = tlogging.report_losses_mean_and_std({k: dict(v) for k, v in acc.items()})
    want = jlogging.report_losses_mean_and_std({k: dict(v) for k, v in acc.items()})
    assert got == want
    for mod, name in ((tlogging, "port"), (jlogging, "jax")):
        log = mod.ExperimentLogger(str(tmp_path), name, tags=["a"])
        log.log_parameters({"lr": 1e-3, "bad": object()})
        log.log_metrics({"x": 1.5}, context="validate", step=2)
        log.log_metric_array("val_SISDRi", [1.0, 2.0], 1)
        log.close()
    for f in ("hparams.json", os.path.join("val_SISDRi", "epoch_1.npy")):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


def test_synthetic_corpus_is_seeded_and_loads(tmp_path):
    a = write_wham_corpus(str(tmp_path / "a"), n_train=3, n_val=2, seconds=0.25, seed=4)
    b = write_wham_corpus(str(tmp_path / "b"), n_train=3, n_val=2, seconds=0.25, seed=4)
    for split, n in (("tr", 3), ("cv", 2)):
        for d in ("mix_clean", "s1", "s2"):
            files = sorted(os.listdir(os.path.join(a, "wav8k", "min", split, d)))
            assert len(files) == n
            for f in files:
                ra = wavfile.read(os.path.join(a, "wav8k", "min", split, d, f))
                rb = wavfile.read(os.path.join(b, "wav8k", "min", split, d, f))
                assert ra[0] == SR and ra[1].shape == (2000,)
                np.testing.assert_array_equal(ra[1], rb[1])
    ds = WhamDataset(**_wham_kwargs(a, timelength=0.25))
    mix, src = ds[0]
    assert np.abs(src).max() > 0.1
    np.testing.assert_allclose(mix, src.sum(0), atol=3 / 32768)


def test_progress_and_visualization_match_jax(tmp_path):
    """The port's progress map and heatmaps, as tests/test_utils_inference.py
    holds JAX's: the same results and the same PNG files (matplotlib is in
    this image), from arrays or tensors."""
    import torch

    from sudo_rm_rf_tpu.utils.progress import progress_bar_wrapper as jprogress
    from sudo_rm_rf_tpu.utils.visualization import log_masks_and_bases as jlog
    from sudo_rm_rf_tpu_torch.utils.progress import progress_bar_wrapper
    from sudo_rm_rf_tpu_torch.utils.visualization import log_masks_and_bases

    assert progress_bar_wrapper(lambda x: x * 2, [1, 2, 3], "doubling") == [2, 4, 6]
    assert jprogress(lambda x: x * 2, [1, 2, 3], "doubling") == [2, 4, 6]
    masks = np.random.default_rng(0).random((2, 16, 50)).astype(np.float32)
    enc = np.random.default_rng(1).random((16, 1, 21)).astype(np.float32)
    dec = np.random.default_rng(2).random((32, 2, 21)).astype(np.float32)
    want = jlog(str(tmp_path / "jax"), masks=masks, encoder_basis=enc, decoder_basis=dec, step=1)
    got = log_masks_and_bases(str(tmp_path / "port"), masks=torch.from_numpy(masks),
                              encoder_basis=enc, decoder_basis=torch.from_numpy(dec), step=1)
    assert len(got) == 4 and [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    assert all(os.path.getsize(p) > 0 for p in got)

    class Experiment:
        def __init__(self):
            self.images = []

        def log_image(self, path, step):
            self.images.append((os.path.basename(path), step))

    exp = Experiment()
    log_masks_and_bases(str(tmp_path / "up"), encoder_basis=enc, step=3, experiment=exp)
    assert exp.images == [("encoder_basis_step3.png", 3)]
