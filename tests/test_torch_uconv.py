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
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

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
    the GlobLN of the whole plane; among the tiles the ladder's (row, time
    tile), which cuts these 1,000-step rows into four."""
    from sudo_rm_rf_tpu_torch.ops.norm import glob_ln

    rng = np.random.default_rng(3)
    v = torch.from_numpy((rng.standard_normal((3, 36, 1000)) * 4 + 7).astype(np.float32))
    g = torch.from_numpy(rng.uniform(0.5, 1.5, 36).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(36).astype(np.float32))
    want = glob_ln(v, g, b)
    ladder = U.ladder_work(3 * 36, 1000)
    assert ladder[0] == 1 and -(-1000 // ladder[1]) == 4
    for rows, cols in [(128, 64), (1, 1000), (1, 81), (16, 32), (5, 1000), U.GEMM_TILE,
                       (1, U.UPSUM_CHUNK), ladder]:
        a, sh = U._fold(v, g, b, rows, cols)
        torch.testing.assert_close(a * v + sh, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows,tout,warp_rows,tiles", [
    (32 * 512, 3200, 1, 1),     # the flagship block at bs32: a row a warp
    (32 * 512, 200, 4, 1),      # its deepest level: four short rows a warp
    (8 * 512, 3200, 1, 1),      # at bs8, the recordings cell's batch
    (4 * 512, 6400, 1, 2),      # U36 at bs4: too few rows to fill the card
    (64 * 32, 200, 1, 1),       # GroupComm's folded deepest level: a pass a row
    (512, 480000, 1, 30),       # the 10-minute block: rows cut at MAX_TILE
    (512, 30000, 1, 8),         # its deepest level: cut to fill the card
    (72, 81, 1, 1),             # a ragged toy level
])
def test_ladder_work_cuts_by_rows_and_length(rows, tout, warp_rows, tiles):
    """The ladder's chooser: a tile that is a multiple of a lane's outputs,
    no longer than MAX_TILE and no shorter than a pass unless the row is;
    several rows a warp only where a row is one tile; and the layouts the
    kernel runs the serving and long-form shapes with."""
    group, tile = U.ladder_work(rows, tout)
    assert tile % U.LADDER_LANE == 0 and tile <= U.LADDER_MAX_TILE
    assert tile >= min(U.LADDER_PASS, tout)
    assert group == 1 or tile >= tout
    assert (group, -(-tout // tile)) == (warp_rows, tiles)


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


@pytest.mark.parametrize("fault", ["none", "shape", "device", "dtype", "grad"])
def test_k1_param_check_runs_on_cpu_tensors(fault):
    """K1's param table through the launch's shared check
    (``_build.check_params``), which runs before any launch: a wrong shape,
    a param on another device than x, a non-float32 param and a param that
    would need a gradient each raise with the wrapper's name; a good table
    passes through as it is, in the order of the C entry point."""
    params, x = _inputs(4, 512, 64, 32)
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
    raises = {
        "shape": (ValueError, r"fused_uconv_block: param dw_w must be a \(4, 64, 5\) tensor"),
        "device": (ValueError, "fused_uconv_block: param res_b .* on meta"),
        "dtype": (ValueError, "fused_uconv_block: param proj_g must be a contiguous float32"),
        "grad": (RuntimeError, "fused_uconv_block has no backward"),
    }
    if fault == "shape":
        tp["dw_w"] = tp["dw_w"][:, :, :4]
    elif fault == "device":
        tp["res_b"] = tp["res_b"].to("meta")
    elif fault == "dtype":
        tp["proj_g"] = tp["proj_g"].double()
    elif fault == "grad":
        tp["proj_w"].requires_grad_()
    if fault == "none":
        got = U._checked_params(torch.from_numpy(x), tp, 4)
        order = ("proj_w", "proj_b", "proj_g", "proj_beta", "proj_slope", "dw_w", "dw_b",
                 "dw_g", "dw_beta", "final_g", "final_beta", "final_slope", "res_w", "res_b")
        assert [id(p) for p in got] == [id(tp[k]) for k in order]
        return
    err, match = raises[fault]
    with pytest.raises(err, match=match):
        U._checked_params(torch.from_numpy(x), tp, 4)


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


# (depth, T, Ci, Co) of the bf16-pyramid checks: the measured block, a
# ragged one of the JAX kernel tests, and one with T % 8 != 0, whose
# upsample-sum takes the kernel's scalar load path
PYRAMID_SHAPES = [(5, 640, 64, 32), (4, 648, 36, 20), (3, 644, 36, 20)]
PYRAMID_MIN_DB = 80.0
PYRAMID_MAX_ABS = 2e-3


def _delta_db(ref, est):
    return float(10 * np.log10((ref.astype(np.float64) ** 2).sum()
                               / ((ref.astype(np.float64) - est) ** 2).sum()))


@functools.lru_cache(maxsize=None)
def _jax_bf16_pyramid(depth, t, ci, co):
    params, x = _inputs(depth, t, ci, co)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    return np.asarray(J.fused_uconv_block(jnp.asarray(x), jp, depth=depth,
                                          pyramid_dtype=jnp.bfloat16, interpret=True))


@pytest.mark.parametrize("depth,t,ci,co", PYRAMID_SHAPES)
def test_bf16_pyramid_matches_jax_kernel(depth, t, ci, co):
    """The plain bf16-pyramid block (levels fed and normalized in fp32,
    stored in bf16 for the upsample-sum) against the JAX kernel with
    ``pyramid_dtype=bfloat16`` in interpret mode: >= 80 dB on the block's
    change (out - x), max |delta| <= 2e-3 (only bf16 rounding flips of
    values the two compute in another order differ). The fp32 pyramid reads
    < 80 dB against the same JAX output: the narrowing happens."""
    params, x = _inputs(depth, t, ci, co)
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
    want = _jax_bf16_pyramid(depth, t, ci, co) - x
    for got in (U.uconv_block_levelwise(torch.from_numpy(x), tp, depth, torch.bfloat16),
                U.fused_uconv_block(torch.from_numpy(x), tp, depth, torch.bfloat16)):
        got = got.numpy() - x
        assert _delta_db(want, got) >= PYRAMID_MIN_DB
        assert np.abs(got - want).max() <= PYRAMID_MAX_ABS
    fp32 = U.uconv_block_levelwise(torch.from_numpy(x), tp, depth).numpy() - x
    assert _delta_db(want, fp32) < PYRAMID_MIN_DB


def test_fused_uconv_block_on_cpu_takes_the_pyramid_dtype():
    """On the CPU a bf16 pyramid runs the plain bf16-pyramid block, not the
    fp32 reference; a pyramid type the kernel lacks raises."""
    params, x = _inputs(4, 512, 64, 32)
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
    xt = torch.from_numpy(x)
    got = U.fused_uconv_block(xt, tp, 4, pyramid_dtype=torch.bfloat16)
    assert U.fused_uconv_block.launches == 0
    torch.testing.assert_close(got, U.uconv_block_levelwise(xt, tp, 4, torch.bfloat16),
                               rtol=0, atol=0)
    assert not torch.equal(got, U.fused_uconv_block(xt, tp, 4))
    with pytest.raises(ValueError, match="pyramid_dtype"):
        U.fused_uconv_block(xt, tp, 4, pyramid_dtype=torch.float16)


def test_fma_block_matmul_hook_routes_both_products():
    """``uconv_block_fma``'s ``matmul`` hook takes the proj and res products
    (JAX's hook, which the int8 path uses) and passes the weights through."""
    params, x = _inputs(4, 512, 64, 32)
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
    seen = []

    def mm(w, v):
        seen.append(tuple(w["w"].shape))
        return torch.matmul(w["w"], v)

    wrapped = dict(tp, proj_w={"q": tp["proj_w"], "w": tp["proj_w"]},
                   res_w={"q": tp["res_w"], "w": tp["res_w"]})
    got = U.uconv_block_fma(torch.from_numpy(x), wrapped, 4, matmul=mm)
    assert seen == [(64, 32), (32, 64)]
    torch.testing.assert_close(got, U.uconv_block_fma(torch.from_numpy(x), tp, 4),
                               rtol=0, atol=0)
