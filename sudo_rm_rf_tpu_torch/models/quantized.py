"""Int8 serving of the Improved and GroupComm SuDoRM-RF (counterpart of
``sudo_rm_rf_tpu/models/quantized.py``).

The serving forward's FLOPs live in the 1x1 convs: the bottleneck (N -> C),
each block's proj (C -> Ci) and res (Ci -> C), and the mask head (C -> S*N),
each a (O, C) x (B, C, T) product. This path quantizes exactly those:

* weights: symmetric per-output-channel int8 (scale = absmax / 127),
  quantized once at load time (:func:`quantize_improved_params`,
  :func:`quantize_gc_params`), from the port's ``nn.Module``;
* activations: symmetric int8, per batch element from the operand's absmax
  (dynamic), or from one calibrated absmax per site (static,
  :func:`calibrate_improved_scales`);
* the int8 x int8 -> int32 product is ``torch._int_mm`` over the operand
  laid out (B*T, C) @ (C, O), dequantized by s_w * s_x into the
  ``compute_dtype`` stream. Rounding is half to even, as in JAX.

Everything else (encoder and decoder convolutions, the depthwise ladder,
GlobLN with fp32 statistics) runs in ``compute_dtype`` (bf16), as the bf16
serving path does. Output fp32. The product is a library call: the JAX
package computes it outside any Pallas kernel (XLA's int8 dot), so no TPU
kernel is ported here.

``torch._int_mm`` on a CUDA card needs M = B*T > 16 and C, O multiples of 8;
a site that breaks that raises (on any device), never falls back to a float
product. Every shipped configuration meets it (256/512/1024 channels for
Improved; 16/32/48 a group for GroupComm U16/512 at group 16).

``fidelity_db`` measures the output SNR against the fp32 forward; the bench
publishes an int8 row only at >= 25 dB (``bench.py``'s gate).
"""

from __future__ import annotations

import torch

from sudo_rm_rf_tpu_torch import ops
from sudo_rm_rf_tpu_torch.models.fast_inference import _dtype, cast_model
from sudo_rm_rf_tpu_torch.models.groupcomm_sudormrf import _tac_fast, gc_uconv_block_fma_merged
from sudo_rm_rf_tpu_torch.ops.uconv import params_from_module, uconv_block_fma

ALL_FAMILIES = ("bottleneck", "proj", "res", "mask")
GC_ALL_FAMILIES = ("bottleneck", "tac_in", "tac_out", "proj", "res", "mask")


def quantize_weight_per_channel(w: torch.Tensor) -> dict:
    """Symmetric per-row int8: w (O, C) -> {'q': int8 (O, C), 's': fp32 (O,)}."""
    w32 = w.detach().float()
    s = w32.abs().amax(dim=1).clamp(min=1e-12) / 127.0
    q = torch.round(w32 / s[:, None]).clamp(-127, 127)
    return {"q": q.to(torch.int8), "s": s}


def quantize_activation(v: torch.Tensor, scale=None):
    """(vq int8 (B, C, T), s_x): symmetric int8 of v with s_x = absmax / 127,
    the absmax per batch element (scale None, s_x (B, 1, 1)) or the given
    calibrated one (a scalar)."""
    v32 = v.float()
    if scale is None:
        amax = v32.abs().amax(dim=(1, 2), keepdim=True)
    else:
        amax = torch.as_tensor(scale, dtype=torch.float32, device=v.device)
    s_x = amax.clamp(min=1e-12) / 127.0
    return torch.round(v32 / s_x).clamp(-127, 127).to(torch.int8), s_x


def int8_product(q: torch.Tensor, vq: torch.Tensor) -> torch.Tensor:
    """out[b, o, t] = sum_c q[o, c] vq[b, c, t] in int32 through
    ``torch._int_mm`` on (B*T, C) @ (C, O). Raises where the card's int8
    GEMM cannot take the shapes."""
    b, c, t = vq.shape
    o = q.shape[0]
    if b * t <= 16 or c % 8 or o % 8:
        raise ValueError(
            f"int8 product needs B*T > 16 and C, O multiples of 8 (torch._int_mm "
            f"on the card); got B*T={b * t}, C={c}, O={o}")
    y = torch._int_mm(vq.transpose(1, 2).reshape(b * t, c), q.t())
    return y.view(b, t, o).transpose(1, 2)


def _mm_int8(w, v: torch.Tensor, out_dtype=torch.bfloat16, scale=None,
             collect=None) -> torch.Tensor:
    """out[b, o, t] = sum_c w[o, c] v[b, c, t] through the int8 product.

    w: {'q': (O, C) int8, 's': (O,) fp32}, or a plain (O, C) float tensor,
    which runs the unquantized product (a family left in ``compute_dtype``).
    v: (B, C, T), any float dtype. scale: None (dynamic per-batch-element
    absmax) or a calibrated absmax. collect: optional list that gets v's
    absmax (the calibration pass)."""
    if not isinstance(w, dict):
        return torch.matmul(w, v).to(out_dtype)
    if collect is not None:
        collect.append(v.float().abs().amax())
    vq, s_x = quantize_activation(v, scale)
    y = int8_product(w["q"], vq)
    return (y.float() * (w["s"][None, :, None] * s_x)).to(out_dtype)


@torch.no_grad()
def quantize_improved_params(model, compute_dtype=torch.bfloat16,
                             families=ALL_FAMILIES) -> dict:
    """The int8 serving dict of a ``SuDORMRFImproved``: the 1x1 weights of
    ``families`` (bottleneck, each block's proj and res, the mask head) as
    int8 ``{'q', 's'}`` pairs, everything else cast to ``compute_dtype``.
    Do this once at load time."""
    from sudo_rm_rf_tpu_torch.models.improved_sudormrf import SuDORMRFImproved

    if not isinstance(model, SuDORMRFImproved):
        raise ValueError(
            f"quantize_improved_params expects a SuDORMRFImproved, got "
            f"{type(model).__name__}; GroupComm models take quantize_gc_params")
    cdt = _dtype(compute_dtype)

    def maybe_q(w, family):
        return quantize_weight_per_channel(w) if family in families else w.detach().to(cdt)

    blocks = []
    for blk in model.sm:
        kp = params_from_module(blk)
        blocks.append({k: v.detach().to(cdt) for k, v in kp.items()}
                      | {"proj_w": maybe_q(kp["proj_w"], "proj"),
                         "res_w": maybe_q(kp["res_w"], "res")})
    prelu, mask_conv = model.mask_net
    return {
        "encoder": model.encoder.weight.detach().to(cdt),
        "ln_gamma": model.ln.gamma.detach().to(cdt),
        "ln_beta": model.ln.beta.detach().to(cdt),
        "bottleneck_w": maybe_q(model.bottleneck.weight[:, :, 0], "bottleneck"),
        "bottleneck_b": model.bottleneck.bias.detach().to(cdt),
        "blocks": blocks,
        "mask_slope": prelu.weight[0].detach().to(cdt),
        "mask_w": maybe_q(mask_conv.weight[:, :, 0], "mask"),
        "mask_b": mask_conv.bias.detach().to(cdt),
        "decoder": model.decoder.weight.detach().to(cdt),
    }


def _site(scales, collector, family, i=None):
    """The scale and the calibration list of one quantized site. A family
    left float has no scales (its weight takes the float product), so its
    site gets None, as JAX looks a scale up only for an int8 weight."""
    sc = None if scales is None or scales[family].numel() == 0 else scales[family]
    if sc is not None and i is not None:
        sc = sc[i]
    col = None if collector is None else collector[family]
    return sc, col


def _head(x, s, qparams, mask_mm, in_len, enc_kernel_size, n_out):
    """Mask head, masking and decoder, as in ``fast_inference._decode``."""
    half = enc_kernel_size // 2
    x = torch.where(x >= 0, x, qparams["mask_slope"] * x)
    x = mask_mm(x) + qparams["mask_b"][None, :, None]
    b, n = x.shape[0], qparams["encoder"].shape[0]
    x = torch.relu(x.reshape(b, n_out, n, -1)) * s[:, None, :, :]
    est = ops.conv_transpose1d(x.reshape(b, n_out * n, -1), qparams["decoder"],
                               stride=half, padding=half, output_padding=half - 1)
    return ops.unpad_to_length(est, in_len).float()


def _front(qparams, input_wav, multiple, enc_kernel_size, cdt):
    """Pad, cast, encode and GlobLN: (x, the encoder features s, in_len)."""
    if input_wav.ndim == 2:
        input_wav = input_wav[:, None, :]
    in_len = input_wav.shape[-1]
    half = enc_kernel_size // 2
    x = ops.pad_to_multiple(input_wav, multiple).to(cdt)
    x = ops.conv1d(x, qparams["encoder"], stride=half, padding=half)
    return ops.glob_ln(x, qparams["ln_gamma"], qparams["ln_beta"]), x, in_len


def _improved_int8(qparams, input_wav, upsampling_depth, enc_kernel_size, num_sources,
                   cdt, scales=None, collector=None):
    """Shared int8 forward. scales: static activation absmax per site
    ({'bottleneck': (), 'proj': (R,), 'res': (R,), 'mask': ()}) or None for
    dynamic; collector: dict of lists the calibration pass fills."""

    def mm(family, i=None):
        sc, col = _site(scales, collector, family, i)
        return lambda w, v: _mm_int8(w, v, out_dtype=cdt, scale=sc, collect=col)

    def block_mm(kp, i):
        """The block's matmul hook: uconv_block_fma calls it for proj and res only."""
        proj, res = mm("proj", i), mm("res", i)
        return lambda w, v: (proj if w is kp["proj_w"] else res)(w, v)

    multiple = (enc_kernel_size // 2) * 2**upsampling_depth
    x, s, in_len = _front(qparams, input_wav, multiple, enc_kernel_size, cdt)
    x = mm("bottleneck")(qparams["bottleneck_w"], x) + qparams["bottleneck_b"][None, :, None]
    for i, kp in enumerate(qparams["blocks"]):
        x = uconv_block_fma(x, kp, upsampling_depth, matmul=block_mm(kp, i))
    return _head(x, s, qparams, lambda v: mm("mask")(qparams["mask_w"], v), in_len,
                 enc_kernel_size, num_sources)


@torch.no_grad()
def improved_forward_int8(qparams: dict, input_wav: torch.Tensor, upsampling_depth: int = 5,
                          enc_kernel_size: int = 21, num_sources: int = 2,
                          compute_dtype="bfloat16", scales: dict = None) -> torch.Tensor:
    """Int8 serving forward over a :func:`quantize_improved_params` dict:
    the dataflow of ``improved_forward_fast(impl='fma')``, with the quantized
    1x1 families through the int8 product. scales: static calibrated
    activation scales (:func:`calibrate_improved_scales`), or None for
    dynamic ones. Output fp32."""
    return _improved_int8(qparams, input_wav, upsampling_depth, enc_kernel_size,
                          num_sources, _dtype(compute_dtype), scales=scales)


# the sites with one scale per block
_PER_BLOCK = ("proj", "res", "tac_in", "tac_out")


def _stack(collector: dict, margin: float) -> dict:
    """The calibrated scales: one scalar per site, stacked per block for the
    block sites (also for a one-block model, where JAX's calibration returns
    a scalar its forward cannot index), empty for a family left float."""
    out = {}
    for k, v in collector.items():
        if not v:
            out[k] = torch.zeros((0,))
        elif k in _PER_BLOCK:
            out[k] = torch.stack(v).float() * margin
        else:
            out[k] = v[0].float() * margin
    return out


@torch.no_grad()
def calibrate_improved_scales(qparams: dict, calib_wav: torch.Tensor, upsampling_depth: int = 5,
                              enc_kernel_size: int = 21, num_sources: int = 2,
                              compute_dtype="bfloat16", margin: float = 1.0) -> dict:
    """Per-site activation absmax on a calibration batch (dynamic scales),
    times ``margin``: the static scales :func:`improved_forward_int8` takes
    (one scalar per quantized site; values past a scale saturate to +-127)."""
    collector = {k: [] for k in ALL_FAMILIES}
    _improved_int8(qparams, calib_wav, upsampling_depth, enc_kernel_size, num_sources,
                   _dtype(compute_dtype), collector=collector)
    return _stack(collector, margin)


# -- GroupComm ----------------------------------------------------------------


@torch.no_grad()
def quantize_gc_params(model, compute_dtype=torch.bfloat16, families=GC_ALL_FAMILIES) -> dict:
    """The int8 serving dict of a ``GroupCommSuDORMRF``. The quantized sites
    are the shared-across-groups 1x1s with the largest operands: TAC input,
    the TAC output's y branch, each UBlock's proj and res, and the
    full-width bottleneck and mask head; the TAC mean branch stays float.
    Float weights stay in place in ``compute_dtype`` (a cast copy of each
    TAC module, the UBlock dicts); the int8 pairs live in each block's
    ``int8`` store."""
    from sudo_rm_rf_tpu_torch.models.groupcomm_sudormrf import GroupCommSuDORMRF

    if not isinstance(model, GroupCommSuDORMRF):
        raise ValueError(
            f"quantize_gc_params expects a GroupCommSuDORMRF, got "
            f"{type(model).__name__}; Improved models take quantize_improved_params")
    cdt = _dtype(compute_dtype)

    def maybe_q(w, family):
        return quantize_weight_per_channel(w) if family in families else None

    blocks = []
    for blk in model.sm:
        tac = blk.TAC
        kp = params_from_module(blk.UBlock)
        h = tac.TAC_input[0].weight.shape[0]
        blocks.append({
            "tac": cast_model(tac, cdt),
            "kp": {k: v.detach().to(cdt) for k, v in kp.items()},
            "int8": {
                "tac_in": maybe_q(tac.TAC_input[0].weight, "tac_in"),
                "tac_out": maybe_q(tac.TAC_output[0].weight[:, :h], "tac_out"),
                "proj": maybe_q(kp["proj_w"], "proj"),
                "res": maybe_q(kp["res_w"], "res"),
            },
        })
    prelu, mask_conv = model.mask_net
    return {
        "encoder": model.encoder.weight.detach().to(cdt),
        "ln_gamma": model.ln.gamma.detach().to(cdt),
        "ln_beta": model.ln.beta.detach().to(cdt),
        "bottleneck_w": model.bottleneck.weight[:, :, 0].detach().to(cdt),
        "bottleneck_b": model.bottleneck.bias.detach().to(cdt),
        "bottleneck_q": maybe_q(model.bottleneck.weight[:, :, 0], "bottleneck"),
        "blocks": blocks,
        "mask_slope": prelu.weight[0].detach().to(cdt),
        "mask_w": mask_conv.weight[:, :, 0].detach().to(cdt),
        "mask_b": mask_conv.bias.detach().to(cdt),
        "mask_q": maybe_q(mask_conv.weight[:, :, 0], "mask"),
        "decoder": model.decoder.weight.detach().to(cdt),
    }


def _gc_int8(qparams, input_wav, upsampling_depth, enc_kernel_size, num_sources, group_size,
             in_audio_channels, cdt, scales=None, collector=None):
    """Shared GC int8 forward over the merged fast path (``_tac_fast`` and
    ``gc_uconv_block_fma_merged``), the quantized products through their
    hooks."""

    def site(family, i=None):
        """A hook that runs int8 when the family was quantized, else the
        float operand it is handed."""
        q = qparams["blocks"][i]["int8"][family] if i is not None else qparams[f"{family}_q"]
        sc, col = _site(scales, collector, family, i)

        def mm(w, v):
            if q is None:
                return torch.matmul(w, v).to(cdt)
            return _mm_int8(q, v, out_dtype=cdt, scale=sc, collect=col)

        return mm

    multiple = (enc_kernel_size // 2) * 2**upsampling_depth
    x, s, in_len = _front(qparams, input_wav, multiple, enc_kernel_size, cdt)
    x = site("bottleneck")(qparams["bottleneck_w"], x) + qparams["bottleneck_b"][None, :, None]
    b, c, t = x.shape
    g = group_size
    for i, blk in enumerate(qparams["blocks"]):
        y = _tac_fast(blk["tac"], x.reshape(b, g, c // g, t),
                      matmuls=(site("tac_in", i), torch.matmul, site("tac_out", i)))
        proj, res = site("proj", i), site("res", i)
        x = gc_uconv_block_fma_merged(
            y.reshape(b, c, t), blk["kp"], upsampling_depth, g,
            matmul=lambda w, v: (proj if w is blk["kp"]["proj_w"] else res)(w, v))
    return _head(x, s, qparams, lambda v: site("mask")(qparams["mask_w"], v), in_len,
                 enc_kernel_size, num_sources * in_audio_channels)


@torch.no_grad()
def groupcomm_forward_int8(qparams: dict, input_wav: torch.Tensor, num_blocks: int = 16,
                           upsampling_depth: int = 5, enc_kernel_size: int = 21,
                           num_sources: int = 2, group_size: int = 16,
                           in_audio_channels: int = 1, compute_dtype="bfloat16",
                           scales: dict = None) -> torch.Tensor:
    """Int8 serving forward over a :func:`quantize_gc_params` dict, the GC
    counterpart of :func:`improved_forward_int8`. scales: static, from
    :func:`calibrate_gc_scales`, or None for dynamic ones. Output fp32."""
    if num_blocks != len(qparams["blocks"]):
        raise ValueError(f"num_blocks {num_blocks} but the dict holds "
                         f"{len(qparams['blocks'])} blocks")
    return _gc_int8(qparams, input_wav, upsampling_depth, enc_kernel_size, num_sources,
                    group_size, in_audio_channels, _dtype(compute_dtype), scales=scales)


@torch.no_grad()
def calibrate_gc_scales(qparams: dict, calib_wav: torch.Tensor, num_blocks: int = 16,
                        upsampling_depth: int = 5, enc_kernel_size: int = 21,
                        num_sources: int = 2, group_size: int = 16, in_audio_channels: int = 1,
                        compute_dtype="bfloat16", margin: float = 1.0) -> dict:
    """Static per-site activation absmax for the GC int8 path."""
    if num_blocks != len(qparams["blocks"]):
        raise ValueError(f"num_blocks {num_blocks} but the dict holds "
                         f"{len(qparams['blocks'])} blocks")
    collector = {k: [] for k in GC_ALL_FAMILIES}
    _gc_int8(qparams, calib_wav, upsampling_depth, enc_kernel_size, num_sources, group_size,
             in_audio_channels, _dtype(compute_dtype), collector=collector)
    return _stack(collector, margin)


def fidelity_db(ref, est) -> float:
    """Output SNR (dB) of ``est`` against the exact reference output."""
    ref = torch.as_tensor(ref).double()
    err = ref - torch.as_tensor(est).double()
    den = max(float((err * err).sum()), 1e-20)
    return float(10.0 * torch.log10((ref * ref).sum() / den))
