"""The port's hierarchical data path against the JAX package and joblib, on
the CPU: the joblib file format both ways, the synthetic hierarchical corpus
against ``scripts/make_synthetic_corpus.py``, the ``prep`` writers, the
AUGMENTED online-mixing items, the convergence check's fixed val set and
``data.setup``'s AUGMENTED generators.

Every comparison is exact: files byte for byte, arrays bit for bit. The
crosscheck's val set is compared whole: 600 mixtures of 2 s at seed 42 over
the val split the script writes (10 speakers x 20 utterances of 4 s).
"""

import importlib.util
import os

import joblib
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sudo_rm_rf_tpu.data import hierarchical as jhier
from sudo_rm_rf_tpu.data import setup as jsetup
from sudo_rm_rf_tpu.prep import hierarchical as jprep
from sudo_rm_rf_tpu_torch.data import hierarchical as thier
from sudo_rm_rf_tpu_torch.data import setup as tsetup
from sudo_rm_rf_tpu_torch.data.synthetic import write_hierarchical_corpus
from sudo_rm_rf_tpu_torch.prep import hierarchical as tprep
from sudo_rm_rf_tpu_torch.utils import joblib_format
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _assert_same_files(a, b):
    names = _tree(a)
    assert names and names == _tree(b)
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def _items_equal(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))


# -- the joblib format ----------------------------------------------------------

_RNG = np.random.default_rng(0)
ARRAYS = {
    "f32_1d": _RNG.standard_normal(7).astype(np.float32),
    "f64_1d_odd": _RNG.standard_normal(1001),
    "f32_row_odd": _RNG.standard_normal((1, 333)).astype(np.float32),
    "f64_row": _RNG.standard_normal((1, 64)),
    "f32_fortran": np.asfortranarray(_RNG.standard_normal((3, 5)).astype(np.float32)),
}


@pytest.mark.parametrize("name", sorted(ARRAYS) + ["torch_tensor"])
def test_joblib_format_reads_joblib_dump(tmp_path, name):
    value = torch.arange(9, dtype=torch.float32) / 7 if name == "torch_tensor" else ARRAYS[name]
    path = str(tmp_path / "x")
    joblib.dump(value, path)
    got = joblib_format.load(path)
    if name == "torch_tensor":  # a plain pickle, as older hierarchical folders hold
        assert torch.equal(got, value)
        return
    assert got.dtype == value.dtype and got.shape == value.shape
    assert np.array_equal(got, value) and got.flags.writeable


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_joblib_reads_joblib_format_dump(tmp_path, name):
    value = ARRAYS[name]
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    joblib_format.dump(value, ours)
    joblib.dump(value, theirs)
    got = joblib.load(ours)
    assert got.dtype == value.dtype and np.array_equal(got, value)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("compress", ["zlib", "gzip", "bz2", "xz", "lzma"])
def test_joblib_format_refuses_compressed_files(tmp_path, compress):
    path = str(tmp_path / "x")
    joblib.dump(ARRAYS["f32_1d"], path, compress=(compress, 3))
    with pytest.raises(ValueError, match=f"{path}: a {compress}-compressed"):
        joblib_format.load(path)


# -- writers --------------------------------------------------------------------


def test_hierarchical_corpus_matches_the_script(tmp_path):
    jax_side = str(tmp_path / "script")
    _script("make_synthetic_corpus").main(
        ["--out", jax_side, "--train_speakers", "3", "--val_speakers", "2",
         "--test_speakers", "2", "--utts", "2", "--val_utts", "2", "--seconds", "1.0",
         "--seed", "5"])
    port = write_hierarchical_corpus(str(tmp_path / "port"), 3, 2, 2, 2, 2, fs=8000,
                                     seconds=1.0, seed=5)
    assert len(_tree(port)) == (3 + 2 + 2) * 2
    _assert_same_files(jax_side, port)


def _write_wav(path, fs, n, seed):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    x = np.random.default_rng(seed).standard_normal(n) * 3000
    wavfile.write(path, fs, x.astype(np.int16))


def _esc50(root):
    for i, (fold, cls) in enumerate([(1, 3), (2, 3), (5, 3), (5, 3), (1, 7), (5, 7)]):
        _write_wav(os.path.join(root, "audio", f"{fold}-10{i}-A-{cls}.wav"), 16000,
                   4000 + 700 * i, i)
    return root


def _wsj0mix(root, n_speakers=2):
    names = ["011a0101_1.2_20aa010b_-1.2", "40na010x_0.5_050c0109_-0.5"]
    seed = 0
    for subset in ("tr", "tt"):
        for k, name in enumerate(names):
            for d in ["mix"] + [f"s{s}" for s in range(1, n_speakers + 1)]:
                seed += 1
                _write_wav(os.path.join(root, subset, d, f"{name}.wav"), 8000,
                           5000 + 1500 * k, seed)
    return root


WRITERS = {
    "from_wavs": lambda m, src, out: m.make_hierarchical_from_wavs(
        sorted(os.path.join(src, "audio", f) for f in os.listdir(os.path.join(src, "audio"))),
        {f: f.split("-")[1] for f in os.listdir(os.path.join(src, "audio"))},
        out, wav_timelength=0.5, sample_rate=8000),
    "esc50_partitions": lambda m, src, out: m.partition_esc50(
        m.convert_esc50_to_hierarchical(src, os.path.join(out, "hier"), 0.5),
        os.path.join(out, "parts")),
    "wsj0mix_preprocessed": lambda m, src, out: m.convert_wsj0mix_to_universal(
        src, out, wav_timelength=0.5),
    "wsj0mix_by_speaker": lambda m, src, out: m.convert_wsj0mix_to_universal(
        src, out, wav_timelength=0.5, hierarchical_by_speaker=True),
}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_prep_writer_matches_jax(tmp_path, writer):
    src = (_wsj0mix if writer.startswith("wsj0mix") else _esc50)(str(tmp_path / "in"))
    WRITERS[writer](jprep, src, str(tmp_path / "jax"))
    WRITERS[writer](tprep, src, str(tmp_path / "port"))
    _assert_same_files(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_resample_poly_matches_jax():
    x = np.random.default_rng(3).standard_normal(1601).astype(np.float32)
    for rates in ((16000, 8000), (44100, 8000), (8000, 8000)):
        assert np.array_equal(tprep.resample_poly(x, *rates), jprep.resample_poly(x, *rates))


# -- AUGMENTED online mixing ------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = write_hierarchical_corpus(str(tmp_path_factory.mktemp("hier")), 4, 3, 3, 3, 3,
                                     fs=8000, seconds=1.0, seed=2)
    # an extra item in each sample folder, for ``return_items``
    for split in ("train", "val"):
        for spk in sorted(os.listdir(os.path.join(root, split))):
            for utt in sorted(os.listdir(os.path.join(root, split, spk))):
                label = np.array([int(spk[3:]), int(utt[3:])], np.int64)
                joblib.dump(label, os.path.join(root, split, spk, utt, "label"))
    return root


@pytest.mark.parametrize("fixed_seed", [42, 0])
def test_augmented_items_match_jax(corpus, fixed_seed):
    kw = dict(input_dataset_p=[os.path.join(corpus, "train"), os.path.join(corpus, "val")],
              datasets_priors=[0.3, 0.7], n_samples=10, sample_rate=8000,
              selected_timelength=0.5, fixed_seed=fixed_seed, seed=3)
    jds, tds = jhier.AugmentedOnlineMixingDataset(**kw), thier.AugmentedOnlineMixingDataset(**kw)
    by_epoch = []
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        items = [tds[i] for i in range(len(tds))]
        assert all(_items_equal(items[i], jds[i]) for i in range(len(jds)))
        assert items[0][0].shape == (4000,) and items[0][1].shape == (2, 4000)
        by_epoch.append(items)
    same = all(_items_equal(a, b) for a, b in zip(*by_epoch))
    assert same == bool(fixed_seed)  # fixed draws repeat; online ones do not


def test_augmented_return_items_match_jax(corpus):
    kw = dict(input_dataset_p=[os.path.join(corpus, "train"), os.path.join(corpus, "val")],
              datasets_priors=[0.3, 0.7], n_samples=6, sample_rate=8000,
              selected_timelength=0.5, fixed_seed=42, return_items=["wav", "label"])
    jds, tds = jhier.AugmentedOnlineMixingDataset(**kw), thier.AugmentedOnlineMixingDataset(**kw)
    for i in range(6):
        got = tds[i]
        assert len(got) == 3 and got[2].shape == (2, 2) and got[2].dtype == np.int64
        assert _items_equal(got, jds[i])


def test_crosscheck_val_set_matches_jax(tmp_path):
    """The convergence check's fixed val set (scripts/torch_training_crosscheck.py
    prep: N_VAL mixtures of SECS at VAL_SEED over the corpus' val split)."""
    cc = _script("torch_training_crosscheck")
    root = write_hierarchical_corpus(str(tmp_path), 0, 10, 0, 60, 20, fs=cc.FS,
                                     seconds=4.0, seed=0)
    kw = dict(input_dataset_p=[os.path.join(root, "val")], datasets_priors=[1.0],
              sample_rate=cc.FS, selected_timelength=cc.SECS, n_samples=cc.N_VAL,
              fixed_seed=cc.VAL_SEED)
    jds, tds = jhier.AugmentedOnlineMixingDataset(**kw), thier.AugmentedOnlineMixingDataset(**kw)
    assert len(tds) == 600
    for i in range(len(tds)):
        assert _items_equal(tds[i], jds[i]), i


def _hparams(corpus, **extra):
    hp = dict(train=["AUGMENTED_WSJMIX"], val=["AUGMENTED_WSJMIX"], test=["AUGMENTED_WSJMIX"],
              train_val=[], batch_size=2, n_jobs=2, n_train=6, n_val=4, n_test=4, fs=8000,
              audio_timelength=0.5,
              **{f"{s}_dataset_paths": [os.path.join(corpus, "val" if s == "test" else s)]
                 for s in ("train", "val", "test")})
    hp.update(extra)
    return hp


def test_setup_builds_augmented_generators_like_jax(corpus):
    got, want = tsetup.setup(_hparams(corpus)), jsetup.setup(_hparams(corpus))
    assert got["train_val"] is None and want["train_val"] is None
    for split in ("train", "val", "test"):
        g, w = got[split], want[split]
        assert (g.shuffle, g.prefetch, g.dataset.fixed_seed) == (
            w.shuffle, w.prefetch, w.dataset.fixed_seed)
        assert g.prefetch == 3 and g.dataset.fixed_seed == (0 if split == "train" else 42)
        for epoch in (0, 1):
            g.dataset.set_epoch(epoch)
            w.dataset.set_epoch(epoch)
            gb, wb = list(g), list(w)
            assert len(gb) == len(w) and all(_items_equal(a, b) for a, b in zip(gb, wb))


def test_source_cache_keeps_its_bound(corpus):
    paths = [os.path.join(corpus, "train", f"spk00{s}", "utt000", "wav") for s in range(3)]
    one = joblib_format.load(paths[0]).nbytes
    cache = thier._DecodedSourceCache(max_bytes=2 * one)
    for p in paths:
        assert np.array_equal(cache.get(p), joblib.load(p))
    assert list(cache._data) == paths[1:] and cache._bytes == 2 * one
    cache.get(paths[1])  # a hit moves it to the back
    cache.get(paths[0])
    assert list(cache._data) == [paths[1], paths[0]]
    off = thier._DecodedSourceCache(max_bytes=0)
    assert np.array_equal(off.get(paths[0]), joblib.load(paths[0])) and not off._data
