"""U-ConvBlock forms of the PyTorch port against the JAX package, on the CPU.

The JAX side runs its Pallas kernel in interpret mode, as
tests/test_pallas_uconv.py does. ``uconv_block_levelwise`` is the CUDA
kernel's own decomposition in plain torch, so these tests check the algorithm
that csrc/uconv.cu carries out; the kernel itself runs only on a GPU
(chip_smoke.py). Tolerances are those of test_pallas_uconv.py: rtol 1e-4,
atol 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sudo_rm_rf_tpu.convert.torch_checkpoint import params_to_state_dict
from sudo_rm_rf_tpu.models.improved_sudormrf import UConvBlock as JaxUConvBlock
from sudo_rm_rf_tpu.ops.pallas import uconv as J
from sudo_rm_rf_tpu_torch.models.improved_sudormrf import UConvBlock
from sudo_rm_rf_tpu_torch.ops import uconv as U

# (depth, T, Ci, Co): the JAX kernel tests' shapes; a ragged one whose
# channel counts fit no GEMM tile and whose deepest level has odd length; one
# whose res GEMM reduces over K = Ci = 512, as the flagship's does, at a short
# T; and one whose Ci, Co and T fit none of the kernel's tiles (64-channel
# sub-tiles, 128-step time tiles, 32-deep k stages, 8-output upsum chunks),
# with T % 4 != 0, so the kernel takes its 4-byte load paths
SHAPES = [(4, 512, 64, 32), (5, 640, 64, 32), (4, 648, 36, 20),
          (3, 128, 512, 256), (2, 334, 100, 70)]
PORT_FORMS = {
    "reference": U.uconv_block_reference,
    "fma": U.uconv_block_fma,
    "levelwise": U.uconv_block_levelwise,
}


def _rand_params(depth, ci, co, seed):
    rng = np.random.default_rng(seed)
    return {
        "proj_w": rng.standard_normal((ci, co)).astype(np.float32) * 0.1,
        "proj_b": rng.standard_normal(ci).astype(np.float32) * 0.1,
        "proj_g": rng.uniform(0.5, 1.5, ci).astype(np.float32),
        "proj_beta": rng.standard_normal(ci).astype(np.float32) * 0.1,
        "proj_slope": np.float32(0.25),
        "dw_w": rng.standard_normal((depth, ci, 5)).astype(np.float32) * 0.3,
        "dw_b": rng.standard_normal((depth, ci)).astype(np.float32) * 0.1,
        "dw_g": rng.uniform(0.5, 1.5, (depth, ci)).astype(np.float32),
        "dw_beta": rng.standard_normal((depth, ci)).astype(np.float32) * 0.1,
        "final_g": rng.uniform(0.5, 1.5, ci).astype(np.float32),
        "final_beta": rng.standard_normal(ci).astype(np.float32) * 0.1,
        "final_slope": np.float32(0.25),
        "res_w": rng.standard_normal((co, ci)).astype(np.float32) * 0.1,
        "res_b": rng.standard_normal(co).astype(np.float32) * 0.1,
    }


def _inputs(depth, t, ci, co):
    params = _rand_params(depth, ci, co, seed=depth + ci)
    x = np.random.default_rng(1).standard_normal((2, co, t)).astype(np.float32)
    return params, x


@functools.lru_cache(maxsize=None)
def _jax_outputs(depth, t, ci, co):
    """(Pallas kernel in interpret mode, JAX reference) on the seeded inputs."""
    params, x = _inputs(depth, t, ci, co)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    kernel = np.asarray(J.fused_uconv_block(jnp.asarray(x), jp, depth=depth, interpret=True))
    ref = np.asarray(J.uconv_block_reference(jnp.asarray(x), jp, depth))
    return kernel, ref


@pytest.mark.parametrize("form", sorted(PORT_FORMS))
@pytest.mark.parametrize("depth,t,ci,co", SHAPES)
def test_port_block_matches_jax(form, depth, t, ci, co):
    params, x = _inputs(depth, t, ci, co)
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
    got = PORT_FORMS[form](torch.from_numpy(x), tp, depth).numpy()
    kernel, ref = _jax_outputs(depth, t, ci, co)
    np.testing.assert_allclose(got, kernel, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_levelwise_fold_equals_glob_ln():
    """Per-tile moments on ragged tiles, merged with Chan's formula, give
    the GlobLN of the whole plane."""
    from sudo_rm_rf_tpu_torch.ops.norm import glob_ln

    rng = np.random.default_rng(3)
    v = torch.from_numpy((rng.standard_normal((3, 36, 81)) * 4 + 7).astype(np.float32))
    g = torch.from_numpy(rng.uniform(0.5, 1.5, 36).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(36).astype(np.float32))
    want = glob_ln(v, g, b)
    for rows, cols in [(128, 64), (1, 81), (16, 32), U.GEMM_TILE, (1, U.UPSUM_CHUNK)]:
        a, sh = U._fold(v, g, b, rows, cols)
        torch.testing.assert_close(a * v + sh, want, rtol=1e-5, atol=1e-5)


def test_params_from_module_matches_params_from_flax():
    """The port's UConvBlock, loaded with a flax block's params, gives the
    same kernel params and the same forward in every block_impl."""
    blk = JaxUConvBlock(out_channels=32, in_channels=64, upsampling_depth=4)
    x = np.random.default_rng(2).standard_normal((2, 32, 512)).astype(np.float32)
    variables = blk.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(blk.apply(variables, jnp.asarray(x)))
    jkp = J.params_from_flax(variables["params"])

    port = UConvBlock(32, 64, 4)
    port.load_state_dict(params_to_state_dict(
        variables["params"], target_keys=port.state_dict().keys(), to_torch=True))
    kp = U.params_from_module(port)
    assert sorted(kp) == sorted(jkp)
    for key in kp:
        np.testing.assert_array_equal(kp[key].detach().numpy(), np.asarray(jkp[key]), err_msg=key)
    with torch.no_grad():
        for impl in ("xla", "fma", "kernel"):
            port.block_impl = impl
            got = port(torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=impl)


def test_fused_uconv_block_on_cpu_runs_plain_version():
    params, x = _inputs(4, 512, 64, 32)
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
    before = U.fused_uconv_block.launches
    got = U.fused_uconv_block(torch.from_numpy(x), tp, 4)
    assert U.fused_uconv_block.launches == before == 0
    torch.testing.assert_close(got, U.uconv_block_reference(torch.from_numpy(x), tp, 4),
                               rtol=0, atol=0)


def test_fused_uconv_block_rejects_other_devices():
    params, x = _inputs(4, 512, 64, 32)
    tp = {k: torch.from_numpy(np.asarray(v)).to("meta") for k, v in params.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        U.fused_uconv_block(torch.from_numpy(x).to("meta"), tp, 4)


def test_tf32_round_is_round_to_nearest_ties_away():
    """``tf32_round`` keeps 10 mantissa bits, rounding to nearest with ties
    away from zero (cvt.rna); the 3xTF32 product is fp32-accurate."""
    ulp = 2.0**-10
    v = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2**-23, 1 + 1.5 * ulp,
                      -(1 + ulp / 2), 3.0, 2.0**-130], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + ulp, 1.0, 1 + 2 * ulp, -(1 + ulp), 3.0, 2.0**-130],
                        dtype=torch.float32)
    torch.testing.assert_close(U.tf32_round(v), want, rtol=0, atol=0)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(10_000).astype(np.float32))
    r = U.tf32_round(x)
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((r - x).abs() <= x.abs() * 2.0**-11).all()
    w = torch.from_numpy(rng.standard_normal((48, 512)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((512, 40)).astype(np.float32))
    want = (w.double() @ a.double()).float()
    torch.testing.assert_close(U.matmul_3xtf32(w, a), want, rtol=1e-5, atol=1e-5)
    one_pass = (U.tf32_round(w) @ U.tf32_round(a) - want).abs().max()
    assert (U.matmul_3xtf32(w, a) - want).abs().max() < one_pass / 100
