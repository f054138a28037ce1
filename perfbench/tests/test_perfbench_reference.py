"""The plain references against the port at toy widths on the CPU: the
forward and the overlap-add front end; and the seeded generators repeating
for a seed."""

import functools

import numpy as np
import pytest
import torch

from perfbench import core, signals, weights
from perfbench.drivers import recordings
from perfbench.reference import improved as ref
from perfbench.reference import overlap_add as ref_oa
from perfbench.tests.conftest import TOY_MODEL


def _toy(seed=3, block_impl="xla"):
    return weights.improved_model(torch, TOY_MODEL, seed, "cpu", block_impl=block_impl)


@pytest.mark.parametrize("impl", ["xla", "fma", "kernel"])
@pytest.mark.parametrize("n_samples", [4000, 3217])
def test_forward_matches_the_port(impl, n_samples):
    from sudo_rm_rf_tpu_torch.models.fast_inference import improved_forward_fast

    model, flat, names = _toy()
    x = signals.mixtures(torch, 3, n_samples, torch.Generator().manual_seed(1), "cpu")
    want = ref.forward(weights.unflatten(flat, names), TOY_MODEL, x)
    got = improved_forward_fast(model, x, impl=impl)
    assert got.shape == want.shape == (3, 2, n_samples)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seconds", [0.3, 0.4, 1.37])
def test_overlap_add_matches_the_port(seconds):
    from sudo_rm_rf_tpu_torch.inference.overlap_add import OverlapAddSeparator
    from sudo_rm_rf_tpu_torch.models.fast_inference import improved_forward_fast

    model, flat, names = _toy()
    chunk = 3200
    mix = signals.mixtures(torch, 1, int(seconds * 8000), torch.Generator().manual_seed(2),
                           "cpu")[0].numpy() * 3.0 + 0.5
    sep = OverlapAddSeparator(model, chunk_samples=chunk, batch_chunks=2,
                              forward_fn=functools.partial(improved_forward_fast, model))
    got = sep.separate(mix)
    w = weights.unflatten(flat, names)
    fwd = lambda frames: ref.forward(  # noqa: E731
        w, TOY_MODEL, torch.from_numpy(frames.astype(np.float32))).numpy()
    want = ref_oa.separate(mix, chunk, 2, fwd, batch=3)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_highpass_takes_out_the_chunk_offset():
    """Brown noise's 4 s chunks carry an offset larger than their spread,
    which both separated sources share and which drowns the alignment's
    choice; above 80 Hz a chunk's mean is near 0."""
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    for hp, lo, hi in ((0.0, 0.3, None), (80.0, None, 1e-2)):
        x = signals.mixtures(torch, 2, 20 * 8000, g(), "cpu", highpass_hz=hp)
        chunks = x.unfold(-1, 32000, 16000)
        offset = float((chunks.mean(-1).abs() / chunks.std(-1)).median())
        assert (lo is None or offset > lo) and (hi is None or offset < hi), (hp, offset)


def test_signals_repeat_for_a_seed():
    g = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    a = signals.mixtures(torch, 3, 800, g(1), "cpu")
    assert torch.equal(a, signals.mixtures(torch, 3, 800, g(1), "cpu"))
    assert not torch.equal(a, signals.mixtures(torch, 3, 800, g(2), "cpu"))
    assert torch.allclose(a.std(dim=-1), torch.ones(3), atol=1e-4)
    assert core.sub_seed(2**31 + 11, "w") == core.sub_seed(2**31 + 11, "w")
    assert core.sub_seed(2**31 + 11, "w") != core.sub_seed(2**31 + 11, "x")
    assert 0 <= core.sub_seed(2**40, "w") < 2**63


def test_recordings_lengths_are_the_seeds_set_in_its_order(recordings_cell):
    tr = core.load_json(core.HERE / "traffic" / "recordings_2_68s.json")
    lengths = recordings.recording_lengths(tr, 8000)
    assert len(lengths) == 64 and lengths.min() >= 16000 and lengths.max() <= 68 * 8000
    assert 18.0 < lengths.mean() / 8000 < 19.5
    # the 95th percentile of a pass lies inside the block of lengths that take
    # 4 forwards of 8 chunks (50-66 s), not at the step from 3 forwards to 4
    chunks = 1 + -(-(lengths - 32000) // 16000)
    forwards = -(-chunks // 8)
    assert forwards[np.argsort(lengths)[int(0.95 * len(lengths))]] == 4
    assert (forwards == 4).sum() >= 4 and (forwards > 4).sum() <= 2
    orders = []
    for seed in (5, 5, 6):
        d = recordings.Driver(recordings_cell, seed, "cpu")
        orders.append([d._next() for _ in range(2 * len(d.lengths))])
    assert orders[0] == orders[1] != orders[2]
    assert sorted(orders[2]) == sorted(orders[0])  # the same work, another order


def test_overlap_add_follows_the_answer_only_at_a_tie(monkeypatch):
    """A separator that takes the second-best order at every chunk: where
    every choice counts as a tie the reference follows it to rounding;
    where none does, the answer is wrong."""
    from sudo_rm_rf_tpu_torch.inference.overlap_add import OverlapAddSeparator
    from sudo_rm_rf_tpu_torch.models.fast_inference import improved_forward_fast

    model, flat, names = _toy()
    chunk = 1600
    mix = signals.mixtures(torch, 1, 12000, torch.Generator().manual_seed(4), "cpu")[0].numpy()
    sep = OverlapAddSeparator(model, chunk_samples=chunk, batch_chunks=4,
                              forward_fn=functools.partial(improved_forward_fast, model))

    def second_best(prev_tail, est):
        first = OverlapAddSeparator._align(sep, prev_tail, est)
        return est[::-1] if np.array_equal(first, est) else est

    monkeypatch.setattr(sep, "_align", second_best)
    got = sep.separate(mix)
    w = weights.unflatten(flat, names)
    fwd = lambda frames: ref.forward(  # noqa: E731
        w, TOY_MODEL, torch.from_numpy(frames.astype(np.float32))).numpy()
    rel = lambda r: float(np.abs(got - r).max() / np.abs(r).max())  # noqa: E731
    assert rel(ref_oa.separate(mix, chunk, 2, fwd, follow=got)) > 1e-2
    monkeypatch.setattr(ref_oa, "TIE", 1.0)
    assert rel(ref_oa.separate(mix, chunk, 2, fwd, follow=got)) < 1e-4
