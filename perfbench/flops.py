"""Operations and bytes of the Improved SuDoRM-RF forward and of one
U-ConvBlock, in closed form from the configuration's shapes.

Products and convolutions are counted (2 flops a multiply-add); a depthwise
convolution is counted as depthwise; elementwise work (norms, PReLU, the
upsample-sum's adds, masking) is left out, so a count is a floor on the
work. ``tests/test_perfbench_flops.py`` holds the forward count to
``FlopCounterMode`` over the plain reference on the meta device.
"""

from __future__ import annotations

from perfbench import peaks


def frames(model: dict, n_samples: int) -> int:
    """Encoder frames T' of an input of ``n_samples``: the model pads to a
    multiple of (L // 2) * 2**depth and the encoder strides by L // 2."""
    half = model["enc_kernel_size"] // 2
    multiple = half * 2 ** model["upsampling_depth"]
    padded = max(-(-n_samples // multiple), 1) * multiple
    return padded // half


def block_flops(b: int, co: int, ci: int, t: int, depth: int) -> dict:
    """One U-ConvBlock at (B, Co, Ci, T', depth): the proj and res 1x1
    products (``gemm``), and the depthwise k=5 ladder, level k at T' / 2**k
    (``ladder``)."""
    return {"gemm": 2 * 2 * b * ci * co * t,
            "ladder": 2 * 5 * b * ci * sum(t >> k for k in range(depth))}


def forward_flops(model: dict, batch: int, n_samples: int) -> int:
    """One forward of a (batch, n_samples) mixture: encoder, bottleneck,
    the blocks, the mask conv and the transposed-conv decoder."""
    t = frames(model, n_samples)
    n, c, ci = model["enc_num_basis"], model["out_channels"], model["in_channels"]
    s, k = model["num_sources"], model["enc_kernel_size"]
    blk = block_flops(batch, c, ci, t, model["upsampling_depth"])
    return int(2 * batch * t * (n * k + n * c + c * s * n + s * n * s * k)
               + model["num_blocks"] * (blk["gemm"] + blk["ladder"]))


def block_least_seconds(b: int, co: int, ci: int, t: int, depth: int) -> dict:
    """Least time one U-ConvBlock call could take on the card: the largest
    of its products over the TF32 peak, its ladder over the fp32 peak, and
    its bytes (x in, out and the params, each once, fp32) over HBM."""
    f = block_flops(b, co, ci, t, depth)
    params = 2 * ci * co + ci * (8 * depth + 5) + co
    terms = {"gemm": f["gemm"] / peaks.TF32_FLOPS,
             "ladder": f["ladder"] / peaks.FP32_SIMT_FLOPS,
             "bytes": 4 * (2 * b * co * t + params) / peaks.HBM_BYTES_PER_S}
    bound = max(terms, key=terms.get)
    return {"seconds": terms[bound], "bound_by": bound, **terms}
