"""Reduced-precision serving of the port against the JAX package, on the CPU:
bf16 serving (``compute_dtype="bfloat16"`` of ``improved_forward_fast`` and
``groupcomm_forward_fast``, every impl; JAX's ``pallas`` blocks in interpret
mode, the port's ``kernel`` blocks through their plain version) and int8
serving (``models/quantized.py``), from the same JAX init and the same numpy
input.

Tolerances: bf16 rounds at other places in the two frameworks, so outputs
are compared as SNRs: the port's bf16 output >= 30 dB from JAX's for the
same impl and >= 35 dB from its own fp32 forward (the bench's gate). int8:
>= 25 dB from fp32 (the bench's int8 gate); against JAX's int8 output >= 45
dB with an fp32 stream around the int8 products (measured 51-138 dB: the
same quantizer on the same values; an output with no int8 product at all
sits ~31 dB from JAX's int8 one), and >= 25 dB with the served bf16 stream
(measured 26.9-31.0 dB: a bf16 rounding that differs flips an activation's
int8 rounding, so the two outputs carry two int8 errors of ~28-32 dB each
that no longer coincide). In both, ``torch._int_mm`` must run once at every
quantized site.
Quantizers: int8 values exactly, scales within 1 ulp; the int8 x int8 ->
int32 product exactly; calibrated scales within 1e-2 relative, in the fp32
stream (in a bf16 stream the operands whose absmax they are differ by the
bf16 error itself, up to 1.7 % at the deepest sites measured).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sudo_rm_rf_tpu import models as jmodels
from sudo_rm_rf_tpu.models import fast_inference as jfi
from sudo_rm_rf_tpu.models import quantized as jq
from sudo_rm_rf_tpu.ops.pallas import uconv as J
from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.convert import load_jax_params
from sudo_rm_rf_tpu_torch.models import fast_inference as tfi
from sudo_rm_rf_tpu_torch.models import quantized as tq
from sudo_rm_rf_tpu_torch.ops import uconv as U
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

# the toy Improved model of the measured table (U3, out 32, in 64, depth 4,
# 64 bases, 2 x 4001 samples) and a two-block GroupComm of group 4
HP = dict(out_channels=32, in_channels=64, num_blocks=3, upsampling_depth=4,
          enc_kernel_size=21, enc_num_basis=64, num_sources=2)
GC_HP = dict(in_audio_channels=1, out_channels=32, in_channels=64, num_blocks=2,
             upsampling_depth=3, enc_kernel_size=21, enc_num_basis=24, num_sources=2,
             group_size=4)
LENGTH = 4001
BF16_VS_JAX_DB, BF16_GATE_DB = 30.0, 35.0
INT8_GATE_DB = 25.0
INT8_VS_JAX_DB = {"float32": 45.0, "bfloat16": 25.0}


def snr_db(ref, est):
    ref, est = np.asarray(ref, np.float64), np.asarray(est, np.float64)
    return float(10 * np.log10((ref**2).sum() / ((ref - est) ** 2).sum()))


def _wave(seed, b=2, t=LENGTH):
    return np.random.default_rng(seed).standard_normal((b, 1, t)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_init(gc: bool):
    hp = GC_HP if gc else HP
    model = jmodels.GroupCommSuDORMRF(**hp) if gc else jmodels.SuDORMRFImproved(**hp)
    params = jax.jit(model.init)(jax.random.key(0), jnp.asarray(_wave(3)))["params"]
    return jax.tree.map(np.asarray, params)


def _port(gc: bool):
    hp = GC_HP if gc else HP
    return load_jax_params(models.get_model("groupcomm_v2" if gc else "relu", **hp),
                           _jax_init(gc))


def _jax_kw(gc: bool):
    hp = GC_HP if gc else HP
    kw = dict(num_blocks=hp["num_blocks"], upsampling_depth=hp["upsampling_depth"],
              enc_kernel_size=hp["enc_kernel_size"], num_sources=hp["num_sources"])
    if gc:
        kw.update(group_size=hp["group_size"], in_audio_channels=hp["in_audio_channels"])
    return kw


def _interpret(x, p, depth=5, **kw):
    return J.fused_uconv_block(x, p, depth=depth, interpret=True)


@functools.lru_cache(maxsize=None)
def _jax_fast(gc: bool, impl: str, compute_dtype):
    """JAX serving output; its 'pallas' blocks in interpret mode.

    JAX's GroupComm 'pallas' forward under bf16 raises (its kernel returns
    fp32, and the mask head's conv then meets bf16 weights; ROADMAP queue
    3). For it, the JAX side is its fp32 'pallas' forward on the
    bf16-rounded params and input: what the port's 'kernel' path computes,
    but for its encoder and first TAC, which run in bf16."""
    params = jax.tree.map(jnp.asarray, _jax_init(gc))
    x = jnp.asarray(_wave(1))
    if gc and impl == "pallas" and compute_dtype == "bfloat16":
        rnd = lambda a: a.astype(jnp.bfloat16).astype(jnp.float32)  # noqa: E731
        params, x, compute_dtype = jax.tree.map(rnd, params), rnd(x), None
    kw = dict(_jax_kw(gc), impl=impl, compute_dtype=compute_dtype)
    if not gc:
        return np.asarray(jfi.improved_forward_fast(params, x, interpret=True, **kw))
    if impl != "pallas":
        return np.asarray(jfi.groupcomm_forward_fast(params, x, **kw))
    orig, jfi.fused_uconv_block = jfi.fused_uconv_block, _interpret
    try:
        return np.asarray(jfi.groupcomm_forward_fast.__wrapped__(params, x, **kw))
    finally:
        jfi.fused_uconv_block = orig


# -- bf16 serving ---------------------------------------------------------------

# port impl -> JAX impl
IMPROVED_IMPLS = {"fma": "fma", "xla": "xla", "kernel": "pallas"}
GC_IMPLS = {"fma_merged": "fma_merged", "xla": "xla", "kernel": "pallas"}


@pytest.mark.parametrize("gc,impl", [(False, i) for i in IMPROVED_IMPLS]
                         + [(True, i) for i in GC_IMPLS])
def test_bf16_serving_matches_jax(gc, impl):
    forward = tfi.groupcomm_forward_fast if gc else tfi.improved_forward_fast
    model = _port(gc)
    x = torch.from_numpy(_wave(1))
    got = forward(model, x, impl=impl, compute_dtype="bfloat16")
    fp32 = forward(model, x, impl=impl)
    assert got.dtype == torch.float32 and got.shape == fp32.shape
    assert all(p.dtype == torch.float32 for p in model.parameters())  # not cast in place
    jax_impl = (GC_IMPLS if gc else IMPROVED_IMPLS)[impl]
    assert snr_db(_jax_fast(gc, jax_impl, "bfloat16"), got) >= BF16_VS_JAX_DB
    assert snr_db(fp32, got) >= BF16_GATE_DB
    # JAX's own fp32 output of the impl is the port's fp32 forward
    np.testing.assert_allclose(fp32.numpy(), _jax_fast(gc, jax_impl, None),
                               rtol=1e-4, atol=1e-5)


def test_bf16_kernel_blocks_run_in_fp32_from_the_rounded_params(monkeypatch):
    """Under bf16 the kernel blocks take the bf16-rounded params upcast to
    fp32 and an fp32 input, and return fp32, as JAX's Pallas kernel does.
    From a copy cast once for 'kernel' they read its own fp32 tensors: no
    cast per call."""
    seen = []

    def spy(x, kp, depth, pyramid_dtype=torch.float32):
        seen.append((x.dtype, {v.dtype for v in kp.values()},
                     bool(torch.equal(kp["proj_w"], kp["proj_w"].bfloat16().float())),
                     kp["proj_w"].data_ptr()))
        return U.uconv_block_reference(x, kp, depth)

    monkeypatch.setattr(tfi, "fused_uconv_block", spy)
    x = torch.from_numpy(_wave(1))
    per_call = tfi.improved_forward_fast(_port(False), x, impl="kernel",
                                         compute_dtype="bfloat16")
    prepared = tfi.cast_model(_port(False), "bfloat16", impl="kernel")
    got = tfi.improved_forward_fast(prepared, x, impl="kernel", compute_dtype="bfloat16")
    torch.testing.assert_close(got, per_call, rtol=0, atol=0)
    own = [blk.proj_1x1.conv.weight.data_ptr() for blk in prepared.sm]
    assert [s[:3] for s in seen] == [(torch.float32, {torch.float32}, True)] * 2 * len(own)
    assert [s[3] for s in seen[len(own):]] == own


def test_cast_model_copies_once_and_keeps_the_caller_module():
    model = _port(False)
    cast = tfi.cast_model(model, "bfloat16")
    assert cast is not model and all(p.dtype == torch.bfloat16 for p in cast.parameters())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert tfi.cast_model(cast, torch.bfloat16) is cast
    assert tfi.cast_model(model, None) is model
    # for the kernel: rounded to bf16, held in fp32, and kept as it is
    kcast = tfi.cast_model(model, "bfloat16", impl="kernel")
    for p, q in zip(model.parameters(), kcast.parameters()):
        assert q.dtype == torch.float32 and torch.equal(q, p.bfloat16().float())
    assert tfi.cast_model(kcast, torch.bfloat16, impl="kernel") is kcast
    assert tfi.cast_model(kcast, torch.bfloat16) is not kcast
    x = torch.from_numpy(_wave(1))
    torch.testing.assert_close(tfi.improved_forward_fast(cast, x, compute_dtype="bfloat16"),
                               tfi.improved_forward_fast(model, x, compute_dtype="bfloat16"),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="floating"):
        tfi.improved_forward_fast(model, x, compute_dtype="int8")


# -- int8 building blocks -----------------------------------------------------------


def test_quantize_weight_per_channel_matches_jax():
    w = np.random.default_rng(4).standard_normal((48, 40)).astype(np.float32) * 0.2
    w[3] = 0.0  # an all-zero row keeps the 1e-12 floor
    want = jq.quantize_weight_per_channel(jnp.asarray(w))
    got = tq.quantize_weight_per_channel(torch.from_numpy(w))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_max_ulp(got["s"].numpy(), np.asarray(want["s"]), maxulp=1)


@pytest.mark.parametrize("scale", [None, 2.5])
def test_int8_product_matches_jax_before_dequantization(scale):
    rng = np.random.default_rng(5)
    w = rng.standard_normal((24, 32)).astype(np.float32)
    v = rng.standard_normal((2, 32, 40)).astype(np.float32)
    wq = jq.quantize_weight_per_channel(jnp.asarray(w))
    # JAX's activation quantizer and product (quantized.py:_mm_int8)
    v32 = jnp.asarray(v)
    amax = (jnp.max(jnp.abs(v32), axis=(1, 2), keepdims=True) if scale is None
            else jnp.asarray(scale, jnp.float32))
    vq = jnp.clip(jnp.round(v32 / (jnp.maximum(amax, 1e-12) / 127.0)), -127, 127).astype(jnp.int8)
    want = jnp.einsum("oc,bct->bot", wq["q"], vq, preferred_element_type=jnp.int32)
    got_vq, _ = tq.quantize_activation(torch.from_numpy(v), scale)
    np.testing.assert_array_equal(got_vq.numpy(), np.asarray(vq))
    got = tq.int8_product(torch.from_numpy(np.asarray(wq["q"])), got_vq)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and dequantized, in fp32
    want_f = jq._mm_int8(wq, v32, out_dtype=jnp.float32, scale=scale)
    got_f = tq._mm_int8({k: torch.from_numpy(np.asarray(a)) for k, a in wq.items()},
                        torch.from_numpy(v), out_dtype=torch.float32, scale=scale)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=1e-6, atol=1e-6)


def test_int8_product_refuses_shapes_the_card_cannot_take():
    q = torch.zeros((16, 12), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 8"):
        tq.int8_product(q, torch.zeros((2, 12, 40), dtype=torch.int8))
    with pytest.raises(ValueError, match="B\\*T > 16"):
        tq.int8_product(torch.zeros((16, 8), dtype=torch.int8),
                        torch.zeros((1, 8, 16), dtype=torch.int8))


# -- int8 forwards --------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_int8(gc: bool, static: bool, cdt: str):
    """(JAX int8 output, its calibrated scales or None)."""
    params = jax.tree.map(jnp.asarray, _jax_init(gc))
    kw = dict(_jax_kw(gc), compute_dtype=cdt)
    if gc:
        qp = jq.quantize_gc_params(params, compute_dtype=cdt)
        calib, fwd = jq.calibrate_gc_scales, jq.groupcomm_forward_int8
    else:
        qp = jq.quantize_improved_params(params, compute_dtype=cdt)
        kw.pop("num_blocks")
        calib, fwd = jq.calibrate_improved_scales, jq.improved_forward_int8
    scales = calib(qp, jnp.asarray(_wave(7)), **kw) if static else None
    out = np.asarray(fwd(qp, jnp.asarray(_wave(1)), scales=scales, **kw))
    return out, (None if scales is None else jax.tree.map(np.asarray, scales))


@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("gc", [False, True], ids=["improved", "groupcomm"])
def test_int8_serving_matches_jax(gc, static, cdt, monkeypatch):
    model = _port(gc)
    int_mm, calls = torch._int_mm, []

    def counted(a, b):
        assert a.dtype == b.dtype == torch.int8
        calls.append((a.shape[1], b.shape[1]))
        return int_mm(a, b)

    monkeypatch.setattr(torch, "_int_mm", counted)
    kw = dict(_jax_kw(gc), compute_dtype=cdt)
    if gc:
        qp = tq.quantize_gc_params(model, compute_dtype=cdt)
        calib, fwd = tq.calibrate_gc_scales, tq.groupcomm_forward_int8
        fp32 = tfi.groupcomm_forward_fast(model, torch.from_numpy(_wave(1)), impl="fma_merged")
    else:
        qp = tq.quantize_improved_params(model, compute_dtype=cdt)
        kw.pop("num_blocks")
        calib, fwd = tq.calibrate_improved_scales, tq.improved_forward_int8
        fp32 = tfi.improved_forward_fast(model, torch.from_numpy(_wave(1)), impl="fma")
    scales = calib(qp, torch.from_numpy(_wave(7)), **kw) if static else None
    calls.clear()
    got = fwd(qp, torch.from_numpy(_wave(1)), scales=scales, **kw)
    # one int8 product at each quantized site: bottleneck, mask and per block
    # proj and res (and GroupComm's TAC in and out), as (C, O) pairs
    r = _jax_kw(gc)["num_blocks"]
    c, ci, n = HP["out_channels"], HP["in_channels"], HP["enc_num_basis"]
    if gc:
        g, h = GC_HP["group_size"], model.sm[0].TAC.TAC_input[0].weight.shape[0]
        c, ci, n = GC_HP["out_channels"], GC_HP["in_channels"], GC_HP["enc_num_basis"]
        block = [(c // g, h), (h, c // g), (c // g, ci // g), (ci // g, c // g)]
    else:
        block = [(c, ci), (ci, c)]
    assert calls == [(n, c)] + block * r + [(c, 2 * n)]
    want, want_scales = _jax_int8(gc, static, cdt)
    assert got.dtype == torch.float32 and got.shape == fp32.shape
    assert snr_db(want, got) >= INT8_VS_JAX_DB[cdt]
    assert snr_db(fp32, got) >= INT8_GATE_DB
    assert tq.fidelity_db(fp32, got) == pytest.approx(snr_db(fp32, got))
    if static:
        assert sorted(scales) == sorted(want_scales)
        for k in scales:
            assert scales[k].shape == want_scales[k].shape, k
            if cdt == "float32":
                np.testing.assert_allclose(scales[k].numpy(), want_scales[k], rtol=1e-2,
                                           err_msg=k)


def test_int8_families_left_in_bf16_and_model_checks():
    """A family left out of ``families`` keeps its bf16 weight and runs the
    float product (nothing collected for it); each quantizer refuses the
    other family's model."""
    model = _port(False)
    qp = tq.quantize_improved_params(model, families=("proj", "res"))
    assert qp["bottleneck_w"].dtype == torch.bfloat16 and isinstance(qp["blocks"][0]["proj_w"], dict)
    kw = dict(upsampling_depth=HP["upsampling_depth"], num_sources=HP["num_sources"])
    scales = tq.calibrate_improved_scales(qp, torch.from_numpy(_wave(7)), **kw)
    assert scales["bottleneck"].numel() == 0 and scales["proj"].shape == (HP["num_blocks"],)
    out = tq.improved_forward_int8(qp, torch.from_numpy(_wave(1)), scales=scales, **kw)
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="GroupComm"):
        tq.quantize_improved_params(_port(True))
    with pytest.raises(ValueError, match="Improved"):
        tq.quantize_gc_params(model)


def test_kernel_pyramid_dtype_on_the_serving_forwards():
    """The 'kernel' impl takes K1's bf16 pyramid (on the CPU its plain
    version): close to the fp32 pyramid's output, not equal to it; the
    other impls have no pyramid and refuse it."""
    x = torch.from_numpy(_wave(1))
    for gc, other in ((False, "fma"), (True, "fma_merged")):
        forward = tfi.groupcomm_forward_fast if gc else tfi.improved_forward_fast
        model = _port(gc)
        fp32 = forward(model, x, impl="kernel")
        got = forward(model, x, impl="kernel", pyramid_dtype=torch.bfloat16)
        assert not torch.equal(got, fp32) and snr_db(fp32, got) >= BF16_GATE_DB
        with pytest.raises(ValueError, match="pyramid_dtype"):
            forward(model, x, impl=other, pyramid_dtype=torch.bfloat16)
