"""The closed-form counts: the forward against FlopCounterMode over the plain
reference on the meta device, and the block's least time against hand
counts."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import flops, peaks, weights
from perfbench.reference import improved as ref

WIDTHS = [
    dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=3,
         enc_kernel_size=21, enc_num_basis=32, num_sources=2),
    dict(out_channels=24, in_channels=40, num_blocks=3, upsampling_depth=4,
         enc_kernel_size=11, enc_num_basis=48, num_sources=3),
]


def _meta_weights(hp):
    from sudo_rm_rf_tpu_torch.models import SuDORMRFImproved

    with torch.device("meta"):
        model = SuDORMRFImproved(**hp)
    return {n: p.detach() for n, p in model.named_parameters()}


@pytest.mark.parametrize("hp", WIDTHS)
@pytest.mark.parametrize("batch,n_samples", [(2, 4000), (3, 5123)])
def test_forward_flops_match_flop_counter(hp, batch, n_samples):
    w = _meta_weights(hp)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref.forward(w, hp, torch.empty((batch, n_samples), device="meta"))
    assert flops.forward_flops(hp, batch, n_samples) == counter.get_total_flops()


def test_frames_follow_the_padding():
    hp = WIDTHS[0]  # multiple 10 * 2**3 = 80 samples, 8 frames each
    assert flops.frames(hp, 80) == 8
    assert flops.frames(hp, 81) == 16
    assert flops.frames(hp, 1) == 8
    assert flops.frames(dict(hp, upsampling_depth=5), 32000) == 3200


def test_block_least_time_by_hand():
    # U16/512 at bs32: the two products 2 * 2 * 32 * 512 * 256 * 3200 flops
    b, co, ci, t, d = 32, 256, 512, 3200, 5
    least = flops.block_least_seconds(b, co, ci, t, d)
    gemm = 4 * 32 * 512 * 256 * 3200
    assert least["gemm"] == pytest.approx(gemm / 495e12)
    assert least["ladder"] == pytest.approx(10 * 32 * 512 * 6200 / 67e12)
    params = 2 * 512 * 256 + 512 * 45 + 256
    assert least["bytes"] == pytest.approx(4 * (2 * 32 * 256 * 3200 + params) / 3.35e12)
    assert least["bound_by"] == "gemm"
    assert least["seconds"] == pytest.approx(0.10846e-3, rel=1e-3)
    # one row of a narrow block is bound by its bytes
    assert flops.block_least_seconds(1, 16, 32, 64, 3)["bound_by"] == "bytes"


def test_peaks_are_the_data_sheets():
    assert (peaks.TF32_FLOPS, peaks.FP32_SIMT_FLOPS,
            peaks.HBM_BYTES_PER_S) == (495e12, 67e12, 3.35e12)


def test_weights_repeat_for_a_seed_and_cover_every_leaf():
    hp = WIDTHS[0]
    m1, f1, names = weights.improved_model(torch, hp, 5, "cpu")
    _, f2, _ = weights.improved_model(torch, hp, 5, "cpu")
    _, f3, _ = weights.improved_model(torch, hp, 6, "cpu")
    assert torch.equal(f1, f2) and not torch.equal(f1, f3)
    assert f1.numel() == sum(p.numel() for p in m1.parameters())
    w = weights.unflatten(f1, names)
    for n, p in m1.named_parameters():
        assert torch.equal(p.detach(), w[n]), n
    assert float(w["ln.gamma"].min()) >= 0.9 and float(w["sm.0.proj_1x1.act.weight"]) > 0.19
