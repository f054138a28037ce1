"""The port's serving path against the JAX package's, on the CPU: the
overlap-add separator, the wav reader and the separation CLI.

Both sides get the same weights and numpy-made audio. Separator outputs agree
to rtol 1e-4, atol 1e-5; the CLIs' int16 wavs to 1 LSB (float rounding can
move a sample across an int16 step).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from sudo_rm_rf_tpu import models as jmodels
from sudo_rm_rf_tpu.cli.separate import main as jax_separate_main
from sudo_rm_rf_tpu.data.base import read_wav as jax_read_wav
from sudo_rm_rf_tpu.inference.overlap_add import OverlapAddSeparator as JaxSeparator
from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.cli.separate import main as separate_main
from sudo_rm_rf_tpu_torch.convert import load_jax_params
from sudo_rm_rf_tpu_torch.data.base import read_wav
from sudo_rm_rf_tpu_torch.inference import OverlapAddSeparator
from sudo_rm_rf_tpu_torch.models.fast_inference import improved_forward_fast
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

HP = dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=3,
          enc_kernel_size=21, enc_num_basis=24, num_sources=2)
CHUNK = 1600


@functools.lru_cache(maxsize=None)
def _jax_model():
    model = jmodels.SuDORMRFImproved(**HP)
    params = model.init(jax.random.key(0), jnp.zeros((1, 1, CHUNK)))["params"]
    return model, params


def _mixture(n, seed):
    t = np.arange(n) / 8000.0
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 300 * t) + 0.2 * np.sin(2 * np.pi * 1700 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("length", [1000, int(3.5 * CHUNK)])
def test_overlap_add_separator_matches_jax(length):
    """Short (one padded chunk) and ~3.5-chunk mixtures; batches of 4 chunks,
    so the last batch is padded with zero chunks."""
    jmodel, params = _jax_model()
    mix = _mixture(length, length)
    want = JaxSeparator(jmodel, params, chunk_samples=CHUNK, batch_chunks=4).separate(mix)
    model = load_jax_params(models.get_model("relu", **HP),
                            jax.tree.map(np.asarray, params))
    for fwd in (None, functools.partial(improved_forward_fast, model)):
        got = OverlapAddSeparator(model, CHUNK, batch_chunks=4, forward_fn=fwd).separate(mix)
        assert got.shape == want.shape == (2, length)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_overlap_add_separator_refuses_mixture_consistency():
    """Only the 'uniform' and 'magsq' weightings exist (their parity with the
    JAX separator is in tests/test_torch_groupcomm.py)."""
    with pytest.raises(ValueError, match="mixture_consistency"):
        OverlapAddSeparator(models.get_model("relu", **HP), CHUNK,
                            mixture_consistency="uniformly")


def test_read_wav_matches_jax(tmp_path):
    path = str(tmp_path / "a.wav")
    wavfile.write(path, 8000, (_mixture(999, 1) * 32767).astype(np.int16))
    sr, got = read_wav(path)
    jsr, want = jax_read_wav(path)
    assert sr == jsr == 8000 and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_separate_cli_matches_jax_cli(tmp_path):
    """The same bare state_dict .pt and wav through both CLIs (overlap-add,
    0.4 s chunks, batches of 2)."""
    model = models.get_model("relu", **HP, generator=torch.Generator().manual_seed(3))
    ckpt = str(tmp_path / "model.pt")
    torch.save(model.state_dict(), ckpt)
    wav = str(tmp_path / "mix.wav")
    wavfile.write(wav, 8000, (_mixture(10400, 2) * 32767).astype(np.int16))
    common = ["--checkpoint", ckpt, "--model_type", "relu", "--input", wav,
              "--chunk_seconds", "0.4", "--batch_chunks", "2"]
    for key in ("out_channels", "in_channels", "num_blocks", "upsampling_depth",
                "enc_kernel_size", "enc_num_basis"):
        common += [f"--{key}", str(HP[key])]
    assert jax_separate_main(common + ["--out_dir", str(tmp_path / "jax")]) == 0
    assert separate_main(common + ["--out_dir", str(tmp_path / "port"),
                                   "--device", "cpu"]) == 0
    for s in (1, 2):
        _, want = wavfile.read(os.path.join(tmp_path, "jax", f"mix_s{s}.wav"))
        _, got = wavfile.read(os.path.join(tmp_path, "port", f"mix_s{s}.wav"))
        assert got.shape == want.shape == (10400,) and got.dtype == np.int16
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_separate_cli_takes_the_jax_mode_flag(tmp_path, monkeypatch, capsys):
    """A JAX argv with ``--mode overlap_add`` runs and writes the same files
    as without it; ``--mode seq_parallel`` with a type other than relu or
    groupcomm_v2 is refused through argparse, as the JAX CLI refuses it."""
    model = models.get_model("relu", **HP, generator=torch.Generator().manual_seed(3))
    ckpt = str(tmp_path / "model.pt")
    torch.save(model.state_dict(), ckpt)
    wav = str(tmp_path / "mix.wav")
    wavfile.write(wav, 8000, (_mixture(4000, 2) * 32767).astype(np.int16))
    common = ["--checkpoint", ckpt, "--model_type", "relu", "--input", wav,
              "--chunk_seconds", "0.4", "--batch_chunks", "2", "--device", "cpu"]
    for key in ("out_channels", "in_channels", "num_blocks", "upsampling_depth",
                "enc_kernel_size", "enc_num_basis"):
        common += [f"--{key}", str(HP[key])]
    assert separate_main(common + ["--out_dir", str(tmp_path / "a"),
                                   "--mode", "overlap_add"]) == 0
    assert separate_main(common + ["--out_dir", str(tmp_path / "b")]) == 0
    for s in (1, 2):
        _, a = wavfile.read(os.path.join(tmp_path, "a", f"mix_s{s}.wav"))
        _, b = wavfile.read(os.path.join(tmp_path, "b", f"mix_s{s}.wav"))
        np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit):
        separate_main(common + ["--out_dir", str(tmp_path / "c"), "--mode", "seq_parallel",
                                "--model_type", "causal"])
    assert "--mode seq_parallel supports model_type 'relu' or 'groupcomm_v2'" in (
        capsys.readouterr().err)
    assert not os.path.exists(tmp_path / "c")
