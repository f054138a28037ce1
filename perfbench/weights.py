"""Seeded weights, made on the device in a few large calls, and the
program's model that holds them.

Each leaf is drawn uniform around a centre from one flat draw on a CUDA
generator (on the CPU in the tests): conv weights at +-1/sqrt(fan in)
(xavier's bound for the encoder and decoder), biases at their conv's bound,
GlobLN gains 1 +- 0.1 and shifts +-0.1, PReLU slopes 0.25 +- 0.05. The
flat vector is kept: the reference reads the same weights from it, by name.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple


def _leaf_law(name: str, shape, shapes: Dict[str, tuple]) -> Tuple[float, float]:
    """(centre, half width) of a leaf's uniform law."""
    if name.endswith("gamma"):
        return 1.0, 0.1
    if name.endswith("beta"):
        return 0.0, 0.1
    if len(shape) == 1 and name.endswith("weight"):  # PReLU slope
        return 0.25, 0.05
    if name.endswith("bias"):
        w = shapes[name[: -len("bias")] + "weight"]
        return 0.0, 1.0 / math.sqrt(w[1] * w[2])
    if name in ("encoder.weight", "decoder.weight"):
        fan_in, fan_out = shape[1] * shape[2], shape[0] * shape[2]
        return 0.0, math.sqrt(6.0 / (fan_in + fan_out))
    return 0.0, 1.0 / math.sqrt(shape[1] * shape[2])


def draw_flat(torch, named_shapes: List[Tuple[str, tuple]], seed: int, device):
    """One flat fp32 vector of every leaf, in ``named_shapes`` order."""
    shapes = dict(named_shapes)
    sizes = [math.prod(s) for _, s in named_shapes]
    laws = [_leaf_law(n, s, shapes) for n, s in named_shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    reps = torch.tensor(sizes, device=device)
    centre = torch.tensor([c for c, _ in laws], device=device).repeat_interleave(reps)
    width = torch.tensor([w for _, w in laws], device=device).repeat_interleave(reps)
    return centre + width * u


def unflatten(flat, named_shapes) -> Dict[str, object]:
    """name -> view of ``flat`` in its shape."""
    out, at = {}, 0
    for name, shape in named_shapes:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def improved_model(torch, hp: dict, seed: int, device, block_impl: str = "xla"):
    """The program's ``SuDORMRFImproved`` at ``hp``, its params filled from
    the seed on ``device``; returns (model, the flat weights, their
    (name, shape) order)."""
    from sudo_rm_rf_tpu_torch.models import SuDORMRFImproved

    keys = ("out_channels", "in_channels", "num_blocks", "upsampling_depth",
            "enc_kernel_size", "enc_num_basis", "num_sources")
    with torch.device("meta"):
        model = SuDORMRFImproved(**{k: hp[k] for k in keys}, block_impl=block_impl)
    model = model.to_empty(device=device)
    named_shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    flat = draw_flat(torch, named_shapes, seed, device)
    # the params get a copy of their own: the program may change them in place
    torch.nn.utils.vector_to_parameters(flat.clone(), list(model.parameters()))
    return model, flat, named_shapes
