"""The port's ``PreprocessedDataset`` against the JAX package's, on the CPU.

On a small wsj0-2mix layout, converted to per-utterance joblib folders by
JAX's ``prep`` writer (which calls ``joblib.dump``) and by the port's (its
own ``utils/joblib_format``): the port's items equal JAX's on both
directories, bit for bit, and the port reads them with ``joblib`` made
unimportable.
"""

import os
import sys

import numpy as np
import pytest
from scipy.io import wavfile

from sudo_rm_rf_tpu.data.preprocessed import PreprocessedDataset as JPreprocessed
from sudo_rm_rf_tpu.prep import hierarchical as jprep
from sudo_rm_rf_tpu_torch.data.preprocessed import PreprocessedDataset
from sudo_rm_rf_tpu_torch.prep import hierarchical as tprep
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

ITEMS = ["mixture_wav", "clean_wav_0", "clean_wav_1", "wav"]


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """{writer: the converted root} of 3 tr and 2 tt wsj0-2mix mixtures of
    0.3-0.6 s, fitted to 0.5 s (so one is zero-padded)."""
    base = tmp_path_factory.mktemp("wsj0mix")
    rng = np.random.default_rng(2)
    for subset, n in (("tr", 3), ("tt", 2)):
        for i in range(n):
            length = int(rng.integers(2400, 4800))
            s = [rng.integers(-9000, 9000, length).astype(np.int16) for _ in range(2)]
            name = f"01{i}a010{i}_0.5_20{i}c0101_-0.5.wav"
            for d, wav in (("s1", s[0]), ("s2", s[1]), ("mix", (s[0] // 2 + s[1] // 2))):
                os.makedirs(base / "in" / subset / d, exist_ok=True)
                wavfile.write(str(base / "in" / subset / d / name), 8000, wav)
    return {w: prep.convert_wsj0mix_to_universal(str(base / "in"), str(base / w), 0.5)
            for w, prep in (("jax", jprep), ("port", tprep))}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("subset,n_samples", [("tr", 0), ("tt", 1)])
def test_items_equal_jax(converted, monkeypatch, writer, subset, n_samples):
    root = os.path.join(converted[writer], subset)
    jds = JPreprocessed(root_dirpath=root, return_items=ITEMS, n_samples=n_samples)
    want = [jds[i] for i in range(len(jds))]
    monkeypatch.setitem(sys.modules, "joblib", None)  # the port must not need it
    got = PreprocessedDataset(root_dirpath=root, return_items=ITEMS, n_samples=n_samples)
    assert got.folders == jds.folders and len(got) == len(want) == {"tr": 3, "tt": 1}[subset]
    for i, w in enumerate(want):
        g = got[i]
        assert len(g) == len(w) == 4
        for a, b in zip(g, w):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (4000,)
            np.testing.assert_array_equal(a, b)


def test_default_items_and_errors(converted, tmp_path):
    ds = PreprocessedDataset(root_dirpath=os.path.join(converted["port"], "tr"))
    assert [x.shape for x in ds[0]] == [(4000,)] * 3
    gen = ds.get_generator(batch_size=2, shuffle=False, num_workers=1)
    assert [b[0].shape for b in gen] == [(2, 4000)]
    with pytest.raises(IOError, match="failed to load"):
        PreprocessedDataset(root_dirpath=os.path.join(converted["port"], "tr"),
                            return_items=["nope"])[0]
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no utterance folders"):
        PreprocessedDataset(root_dirpath=str(tmp_path / "empty"))
