"""PyTorch port (sudo_rm_rf_tpu_torch.ops) against the JAX ops, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. fp32
results agree to float rounding (rtol 1e-5, atol 1e-6); bf16 ones to a bf16
ulp or two (see test_glob_ln_bf16).
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sudo_rm_rf_tpu import ops as jops
from sudo_rm_rf_tpu.ops import pad as jpad
from sudo_rm_rf_tpu_torch import ops as tops
from sudo_rm_rf_tpu_torch.ops import pad as tpad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_glob_ln_fp32():
    x, g, b = _rand((2, 6, 50), 0, 3.0, 1.0), _rand(6, 1), _rand(6, 2)
    want = jops.glob_ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    got = tops.glob_ln(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b))
    _close(got.numpy(), want)


def test_glob_ln_bf16():
    """The low-precision branch: fp32 statistics, folded scale/shift applied
    in bf16. The two frameworks round the bf16 multiply-add at different
    places, so results agree to a bf16 ulp or two (2**-7 relative)."""
    x, g, b = _rand((2, 6, 50), 3, 3.0, 1.0), _rand(6, 4), _rand(6, 5)
    want = jops.glob_ln(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16),
                        jnp.asarray(b, jnp.bfloat16))
    got = tops.glob_ln(torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16(),
                       torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), rtol=2**-6, atol=2**-6)


@pytest.mark.parametrize("length", [1, 319, 320, 321, 661])
def test_pad_and_unpad(length):
    assert tpad.padded_length(length, 320) == jpad.padded_length(length, 320)
    x = _rand((2, 1, length), length)
    want = jops.pad_to_multiple(jnp.asarray(x), 320)
    got = tops.pad_to_multiple(torch.from_numpy(x), 320)
    _close(got.numpy(), want, rtol=0, atol=0)
    back = tops.unpad_to_length(got, length)
    _close(back.numpy(), jops.unpad_to_length(want, length), rtol=0, atol=0)


def test_upsample_nearest_2x():
    x = _rand((2, 3, 7), 6)
    want = jops.upsample_nearest_2x(jnp.asarray(x))
    _close(tops.upsample_nearest_2x(torch.from_numpy(x)).numpy(), want, rtol=0, atol=0)


@pytest.mark.parametrize("stride,padding,groups", [(1, 0, 1), (2, 2, 1), (1, 2, 4), (2, 2, 8)])
def test_conv1d(stride, padding, groups):
    x, w, b = _rand((2, 8, 37), 7), _rand((8, 8 // groups, 5), 8), _rand(8, 9)
    want = jops.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                       stride=stride, padding=padding, groups=groups)
    got = tops.conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                      stride=stride, padding=padding, groups=groups)
    _close(got.numpy(), want)


def test_conv_transpose1d_decoder_shape():
    """The decoder's transposed conv: k=21, stride 10, pad 10, output_padding 9."""
    x, w = _rand((2, 6, 13), 10), _rand((6, 2, 21), 11)
    want = jops.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), stride=10,
                                 padding=10, output_padding=9)
    got = tops.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w), stride=10,
                                padding=10, output_padding=9)
    assert got.shape == want.shape
    _close(got.numpy(), want)


@pytest.mark.parametrize("step", [8, 5])
def test_overlap_and_add(step):
    x = _rand((2, 7, 16), 12)
    want = jops.overlap_and_add(jnp.asarray(x), step)
    _close(tops.overlap_and_add(torch.from_numpy(x), step).numpy(), want)


def test_port_imports_no_jax_and_never_falls_back(tmp_path):
    """In a fresh interpreter, the whole port imports, runs a toy forward and
    separates a tiny wav through ``sudo-torch-separate`` on the CPU without
    importing JAX or any module of the JAX package; asking for CUDA where
    there is none raises."""
    code = textwrap.dedent("""
        import os, sys
        import numpy as np
        import torch
        from scipy.io import wavfile
        import sudo_rm_rf_tpu_torch
        from sudo_rm_rf_tpu_torch import convert, data, inference, models, ops
        from sudo_rm_rf_tpu_torch.cli import separate
        from sudo_rm_rf_tpu_torch.convert import jax_params, torch_checkpoint
        from sudo_rm_rf_tpu_torch.data import base
        from sudo_rm_rf_tpu_torch.inference import overlap_add
        from sudo_rm_rf_tpu_torch.models import fast_inference, improved_sudormrf, layers
        from sudo_rm_rf_tpu_torch.models.fast_inference import improved_forward_fast
        from sudo_rm_rf_tpu_torch.ops import _build, conv, frame, norm, pad, resample, uconv

        hp = dict(out_channels=8, in_channels=16, num_blocks=1, upsampling_depth=2,
                  enc_num_basis=8)
        m = models.get_model("relu", **hp)
        x = torch.randn(1, 1, 100, generator=torch.Generator().manual_seed(0))
        for impl in ("kernel", "fma", "xla"):
            assert improved_forward_fast(m, x, impl=impl).shape == (1, 2, 100)
        tmp = sys.argv[1]
        ckpt, wav = os.path.join(tmp, "m.pt"), os.path.join(tmp, "mix.wav")
        torch.save(m.state_dict(), ckpt)
        wavfile.write(wav, 8000, (np.random.default_rng(0).standard_normal(900)
                                  * 3000).astype(np.int16))
        argv = ["--checkpoint", ckpt, "--input", wav, "--out_dir", tmp,
                "--device", "cpu", "--chunk_seconds", "0.05", "--batch_chunks", "2"]
        for k, v in hp.items():
            argv += [f"--{k}", str(v)]
        assert separate.main(argv) == 0
        assert os.path.exists(os.path.join(tmp, "mix_s2.wav"))
        assert uconv.fused_uconv_block.launches == 0
        foreign = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "sudo_rm_rf_tpu"))
        assert not foreign, foreign
        if not torch.cuda.is_available():
            for call in (
                lambda: models.get_model("relu", num_blocks=1, device="cuda"),
                lambda: separate.main(["--checkpoint", "absent.pt", "--input",
                                       "absent.wav", "--device", "cuda"]),
            ):
                try:
                    call()
                except (RuntimeError, AssertionError):
                    continue
                raise SystemExit("a CUDA request without CUDA did not raise")
        print("PORT-OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "PORT-OK" in proc.stdout, proc.stdout + proc.stderr


@pytest.mark.parametrize("saved", ["state_dict", "module"])
def test_torch_checkpoint_copy_matches_jax_package(tmp_path, saved):
    """The port's own copy of the checkpoint renaming and ``.pt`` loader
    gives what the JAX package's ``convert.torch_checkpoint`` gives."""
    from sudo_rm_rf_tpu.convert import torch_checkpoint as jtc
    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.convert import torch_checkpoint as ttc

    model = models.get_model("relu", out_channels=8, in_channels=16, num_blocks=2,
                             upsampling_depth=2, enc_num_basis=8,
                             generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "m.pt")
    torch.save(model.state_dict() if saved == "state_dict" else model, path)
    sd, attrs = ttc.load_pt_file(path)
    jsd, jattrs = jtc.load_pt_file(path)
    assert attrs == jattrs and list(sd) == list(jsd)
    for key in sd:
        assert torch.equal(sd[key], jsd[key]), key
        assert ttc.torch_key_to_flax_path(key) == jtc.torch_key_to_flax_path(key)
    tree = jtc.state_dict_to_params(sd)
    got = ttc.params_to_state_dict(tree, sd.keys())
    want = jtc.params_to_state_dict(tree, target_keys=sd.keys(), to_torch=True)
    assert sorted(got) == sorted(want)
    for key in got:
        assert torch.equal(got[key], want[key]), key
    with pytest.raises(ValueError, match="no torch key"):
        ttc.params_to_state_dict(tree, list(sd)[1:])
