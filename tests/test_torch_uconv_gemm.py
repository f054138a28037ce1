"""K1's two GEMM routes (``csrc/uconv.cu``): the wide one for products of 128
or more output and input channels, the narrow one below.

On the CPU: the route chooser's mirror (``ops/uconv.py::gemm_wide``) on every
K1 shape the repo runs, and no GEMM launch counted by the plain version.

On a card (``card``: skip without one): the library's chooser equals the
mirror; the kernel at those shapes, with each pyramid, against the plain
block (fp32 within rtol = atol = 1e-4, bf16 up to its rounding flips) and
two calls bit-identical; the count of wide GEMM launches a call. Run there with ``python -m pytest --noconftest
tests/test_torch_uconv_gemm.py -m card`` (tests/conftest.py imports JAX).

Tolerance: rtol = atol = 1e-4, as ``chip_smoke.py`` holds K1 to the plain
block; the kernel's 3xTF32 products and float64 folds sit within 1e-5 of it
at these shapes in fp32.
"""

import pytest
import torch

from sudo_rm_rf_tpu_torch.ops import uconv as U
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

TOL = dict(rtol=1e-4, atol=1e-4)

# (B, Co, Ci, T, depth) of the K1 calls the repo makes, and the wide GEMM
# launches of one call: the proj product is (Ci, Co), the res product (Co, Ci)
SHAPES = {
    "flagship-bs4": ((4, 256, 512, 3200, 5), 2),
    "flagship-bs8": ((8, 256, 512, 3200, 5), 2),
    "flagship-bs32": ((32, 256, 512, 3200, 5), 2),
    "u36-bs4": ((4, 512, 512, 6400, 5), 2),
    "u36_wide": ((4, 512, 2048, 3200, 5), 2),
    "u8-256": ((4, 128, 256, 1600, 5), 2),
    "ten-minutes": ((1, 256, 512, 480000, 5), 2),
    "ragged-t": ((8, 256, 512, 3216, 5), 2),
    "groupcomm-folded": ((512, 16, 32, 3200, 5), 0),
    "toy": ((2, 70, 100, 334, 2), 0),
}


def _params(depth, ci, co, seed=0, device="cpu"):
    """Seeded block params in the kernel's dict layout, GlobLN gains and
    shifts drawn around their init so that no leaf is trivial."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    p = {"proj_w": r(ci, co) / co ** 0.5, "proj_b": 0.1 * r(ci), "proj_g": 1 + 0.1 * r(ci),
         "proj_beta": 0.1 * r(ci), "proj_slope": torch.tensor(0.25),
         "dw_w": r(depth, ci, 5) / 5 ** 0.5, "dw_b": 0.1 * r(depth, ci),
         "dw_g": 1 + 0.1 * r(depth, ci), "dw_beta": 0.1 * r(depth, ci),
         "final_g": 1 + 0.1 * r(ci), "final_beta": 0.1 * r(ci),
         "final_slope": torch.tensor(0.25), "res_w": r(co, ci) / ci ** 0.5,
         "res_b": 0.1 * r(co)}
    return {k: v.to(device) for k, v in p.items()}


@pytest.fixture
def card(monkeypatch):
    """A CUDA card with fp32 as fp32 (no TF32 in cuBLAS or cuDNN), or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("K1 is a CUDA kernel: needs a card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return "cuda"


# --------------------------------------------------------------------- CPU


@pytest.mark.parametrize("name", SHAPES)
def test_route_of_every_k1_shape(name):
    """The wide route takes both products of every Improved block, the
    U8/256 block and the 10-minute pass; GroupComm's folded 16- and
    32-channel products and the toy block keep the narrow one. The route
    does not read B or T."""
    (b, co, ci, t, depth), wide = SHAPES[name]
    assert U.gemm_wide(ci, co) + U.gemm_wide(co, ci) == wide


@pytest.mark.parametrize("m,k,wide", [
    (128, 128, True), (127, 512, False), (512, 127, False), (2048, 512, True),
    (32, 16, False), (16, 32, False), (200, 136, True), (150, 130, True),
])
def test_route_is_both_widths_at_least_a_tile(m, k, wide):
    assert U.gemm_wide(m, k) is wide
    assert (m >= U.GEMM_WIDE_MIN and k >= U.GEMM_WIDE_MIN) is wide


def test_plain_version_counts_no_gemm_launch():
    """On the CPU a block of wide products runs the plain version and
    counts no launch."""
    p = _params(2, 128, 128)
    x = torch.randn(1, 128, 64, generator=torch.Generator().manual_seed(1))
    before = U.fused_uconv_block.gemm_wide_launches
    torch.testing.assert_close(U.fused_uconv_block(x, p, 2), U.uconv_block_reference(x, p, 2),
                               rtol=0, atol=0)
    assert U.fused_uconv_block.gemm_wide_launches == before


# -------------------------------------------------------------------- card

# the card cases: the serving shapes, a ragged T, U8/256, and products
# whose M, K and T are no multiple of the tiles (the second with K % 4 != 0:
# W's 4-byte loads; T odd: x's)
CARD_SHAPES = [(32, 256, 512, 3200, 5), (8, 256, 512, 3216, 5), (4, 512, 512, 6400, 5),
               (4, 128, 256, 1600, 5), (2, 136, 200, 1002, 2), (2, 130, 150, 1001, 1),
               (64, 16, 32, 3200, 5)]


@pytest.mark.card
def test_library_chooser_equals_the_mirror(card):
    from sudo_rm_rf_tpu_torch.ops._build import load_kernels

    lib = load_kernels()
    for m in (1, 16, 32, 64, 127, 128, 129, 256, 512, 2048):
        for k in (1, 16, 32, 64, 127, 128, 129, 256, 512, 2048):
            assert bool(lib.gemm_wide(m, k)) is U.gemm_wide(m, k), (m, k)


@pytest.mark.card
@pytest.mark.parametrize("pyramid", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_the_plain_block_and_repeats_bit_for_bit(shape, pyramid, card):
    """fp32: against ``uconv_block_reference`` within rtol = atol = 1e-4.
    bf16: against ``uconv_block_levelwise`` with the same pyramid, the plain
    version of the bf16 store, where an output that rounds to the other
    side of a bf16 step differs by that step: the rule of ``chip_smoke.py``
    (``PYRAMID_MIN_DB``, ``PYRAMID_FLIP_MAX``), at least 80 dB on the
    block's change and no output more than 1e-2 apart."""
    b, co, ci, t, depth = shape
    p = _params(depth, ci, co, device=card)
    x = torch.randn(b, co, t, generator=torch.Generator().manual_seed(1)).to(card)
    with torch.no_grad():
        got = U.fused_uconv_block(x, p, depth, pyramid)
        if pyramid == torch.float32:
            torch.testing.assert_close(got, U.uconv_block_reference(x, p, depth), **TOL)
        else:
            want = U.uconv_block_levelwise(x, p, depth, pyramid).double() - x.double()
            noise = (got.double() - x.double() - want).pow(2).sum()
            assert 10 * torch.log10(want.pow(2).sum() / noise) >= 80.0
            assert (got.double() - x.double() - want).abs().max() <= 1e-2
        assert torch.equal(got, U.fused_uconv_block(x, p, depth, pyramid))


@pytest.mark.card
@pytest.mark.parametrize("shape,wide", [
    ((32, 256, 512, 3200, 5), 2), ((8, 256, 512, 3200, 5), 2), ((4, 512, 512, 6400, 5), 2),
    ((512, 16, 32, 3200, 5), 0)], ids=["bs32", "bs8", "u36-bs4", "groupcomm-bs32"])
def test_wide_launches_a_call(shape, wide, card):
    b, co, ci, t, depth = shape
    p = _params(depth, ci, co, device=card)
    x = torch.randn(b, co, t, generator=torch.Generator().manual_seed(1)).to(card)
    before, launches = U.fused_uconv_block.gemm_wide_launches, U.fused_uconv_block.launches
    with torch.no_grad():
        U.fused_uconv_block(x, p, depth)
        U.fused_uconv_block(x, p, depth)
    assert U.fused_uconv_block.launches - launches == 2
    assert U.fused_uconv_block.gemm_wide_launches - before == 2 * wide
