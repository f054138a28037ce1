"""The port's native wav reader (``native/``) and the readers built on it
(``data/base.py``) against scipy and the JAX package's ``native`` and
``data/base.py``, on the CPU: windows with starts, a stereo downmix, a
missing file, the scipy fallback, and the header-only length probe. Decoded
samples within 1e-6 (JAX's own bound, ``tests/test_native_io.py``); the
frame counts and the library's existence exactly.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
from scipy.io import wavfile

from sudo_rm_rf_tpu import native as jnative
from sudo_rm_rf_tpu.data import base as jbase
from sudo_rm_rf_tpu_torch import native
from sudo_rm_rf_tpu_torch.data import base
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

SR = 8000


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    paths, raws = [], []
    for i in range(6):
        wav = (rng.standard_normal(SR * (1 + i % 3)) * 8000).astype(np.int16)
        p = str(d / f"w{i}.wav")
        wavfile.write(p, SR, wav)
        paths.append(p)
        raws.append(wav.astype(np.float32) / 32768.0)
    stereo = (rng.standard_normal((SR, 2)) * 8000).astype(np.int16)
    sp = str(d / "stereo.wav")
    wavfile.write(sp, SR, stereo)
    return paths, raws, sp, stereo


def _window(raw, start, want):
    out = np.zeros(want, np.float32)
    chunk = raw[start:start + want]
    out[:len(chunk)] = chunk
    return out


def test_native_lib_builds_into_the_port_build_dir():
    assert native.available(), "g++ is here; the native library must build"
    so = native.library_path()
    assert so.exists() and so.parent.name == "_build" and so.name.startswith("libwavio_")
    assert so.parent.parent.name == "sudo_rm_rf_tpu_torch"


def test_wav_info_matches_scipy_and_jax(wavs):
    paths, raws, sp, _ = wavs
    for p, raw in zip(paths, raws):
        assert native.wav_info(p) == (len(raw), SR, 1) == jnative.wav_info(p)
    assert native.wav_info(sp) == (SR, SR, 2) == jnative.wav_info(sp)


@pytest.mark.parametrize("with_starts", [False, True], ids=["from_0", "starts"])
def test_read_batch_matches_scipy_and_jax(wavs, with_starts):
    paths, raws, _, _ = wavs
    starts = [100 * i for i in range(len(paths))] if with_starts else None
    want = 500 if with_starts else SR
    out = native.read_batch(paths, want, starts=starts, n_threads=4)
    assert out.shape == (len(paths), want) and out.dtype == np.float32
    for i, raw in enumerate(raws):
        np.testing.assert_allclose(out[i], _window(raw, starts[i] if starts else 0, want),
                                   atol=1e-6)
    np.testing.assert_array_equal(out, jnative.read_batch(paths, want, starts=starts))


def test_stereo_downmix(wavs):
    _, _, sp, stereo = wavs
    out = native.read_batch([sp], SR)
    np.testing.assert_allclose(out[0], stereo.astype(np.float32).mean(axis=1) / 32768.0,
                               atol=1e-6)
    np.testing.assert_array_equal(out, jnative.read_batch([sp], SR))


def test_missing_file_raises():
    with pytest.raises(IOError):
        native.read_batch(["/nonexistent/x.wav"], 100)
    with pytest.raises(IOError):
        native.wav_info("/nonexistent/x.wav")


def test_python_fallback_matches(wavs, monkeypatch):
    paths, _, sp, _ = wavs
    fast = native.read_batch(paths + [sp], SR, starts=[7] * (len(paths) + 1))
    monkeypatch.setattr(native, "get_lib", lambda: None)
    slow = native.read_batch(paths + [sp], SR, starts=[7] * (len(paths) + 1))
    np.testing.assert_allclose(fast, slow, atol=1e-6)
    assert native.wav_info(sp) == (SR, SR, 2)


def test_disable_switch_takes_the_scipy_path(wavs):
    """SUDO_TPU_DISABLE_NATIVE: no library, the same samples through scipy."""
    paths, raws, _, _ = wavs
    code = ("import sys; from sudo_rm_rf_tpu_torch import native; "
            "from sudo_rm_rf_tpu_torch.data.base import read_wav_window; "
            "assert not native.available(); "
            f"w = read_wav_window({paths[1]!r}, 123, 300); sys.stdout.write(w.tobytes().hex())")
    env = dict(os.environ, SUDO_TPU_DISABLE_NATIVE="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, check=True).stdout
    got = np.frombuffer(bytes.fromhex(out), np.float32)
    np.testing.assert_allclose(got, _window(raws[1], 123, 300), atol=1e-6)


def test_read_wav_window_and_wav_frames_match_jax(wavs):
    paths, raws, sp, _ = wavs
    for start, want in ((0, 100), (SR - 50, 200), (3 * SR, 64)):
        got = base.read_wav_window(paths[2], start, want)
        np.testing.assert_array_equal(got, jbase.read_wav_window(paths[2], start, want))
        np.testing.assert_allclose(got, _window(raws[2], start, want), atol=1e-6)
    np.testing.assert_array_equal(base.read_wav_window(sp, 5, 99),
                                  jbase.read_wav_window(sp, 5, 99))
    assert [base.wav_frames(p) for p in paths] == [jbase.wav_frames(p) for p in paths] \
        == [len(r) for r in raws]


def test_length_metadata_probes_headers_and_matches_jax(wavs, tmp_path, monkeypatch):
    """The header-only probe writes JAX's cache file, and decodes nothing."""
    paths, raws, _, _ = wavs
    calls = []
    real = base.read_wav
    monkeypatch.setattr(base, "read_wav", lambda p: calls.append(p) or real(p))
    got = base.length_metadata(str(tmp_path), paths, expected_sr=SR)
    assert calls == []
    (tmp_path / "jax").mkdir()
    (tmp_path / "rate").mkdir()
    want = jbase.length_metadata(str(tmp_path / "jax"), paths, expected_sr=SR)
    assert got == want == [(os.path.basename(p), len(r)) for p, r in zip(paths, raws)]
    with open(tmp_path / "metadata", "rb") as fh:
        assert pickle.load(fh) == got
    with pytest.raises(base.DatasetConfigError, match="sample rate"):
        base.length_metadata(str(tmp_path / "rate"), paths, expected_sr=16000)
