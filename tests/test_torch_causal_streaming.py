"""The port's multi-stream ``StreamingSeparator`` with the causal SuDoRM-RF
v3, on the CPU at toy widths: against the benchmark's plain reference
(``perfbench/reference/causal.py``: the causal forward and the streaming
rule), its invariants, its spans and its counters.

Toy hparams: out 16, in 32, two blocks, depth 2, basis 16 (padding granule
40), seeded random weights with every ``skipinit_gain`` non-zero (a fresh
model's blocks pass their input through, and would hide them from the
comparison). Hop 40 and context 160: the window (200 samples, 5 hops) is
cold, part zeros, for the first 4 steps and full from the fifth on.

On a card (``card``: skip without one), where a step replays the model's
stages as CUDA graphs: the replays against the eager forward, bit for bit,
at toy widths and at the benchmark cell's sizes. Run there with
``python -m pytest --noconftest tests/test_torch_causal_streaming.py -m
card`` (tests/conftest.py imports JAX).

Tolerance against the reference: rtol 1e-5, atol 1e-6. Both sides run the
same fp32 convolutions over the same windows in one batch, with the masks
applied to the weights; they differ in how the sums are written (the
reference's PReLU, nearest upsample and mask are its own), which moves no
fp32 result past a few ulps. Bit-for-bit comparisons are between the
port's own forwards at one batch size: a library convolution may order a
batch's sums by its size (and the module's fixture keeps one intra-op
thread).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.inference import StreamingSeparator
from sudo_rm_rf_tpu_torch.models.causal_sudormrf import CausalConv1d
from sudo_rm_rf_tpu_torch.utils import tracing
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.reference import causal as ref  # noqa: E402

HP = dict(in_audio_channels=1, out_channels=16, in_channels=32, num_blocks=2,
          upsampling_depth=2, enc_kernel_size=21, enc_num_basis=16, num_sources=2)
HOP, CONTEXT = 40, 160
WINDOW = HOP + CONTEXT
STEPS = 8  # 4 cold windows, then full ones
TOL = dict(rtol=1e-5, atol=1e-6)


def _model(seed=0):
    model = models.get_model("causal", **HP, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for i, blk in enumerate(model.sm):
            blk.skipinit_gain.fill_(0.6 - 0.25 * i)
    return model.eval()


def _audio(n, seed=1, length=900):
    return np.random.default_rng(seed).standard_normal((n, length)).astype(np.float32)


def _stream(sep, audio, steps=STEPS):
    """Every step's emissions of ``sep`` fed ``audio`` (N, L) hop by hop."""
    return [sep.push(ref.windows(audio, t, HOP, HOP)) for t in range(steps)]


@pytest.mark.parametrize("n", [1, 3, 16])
def test_emissions_match_the_reference(n):
    model = _model()
    w = {k: p.detach() for k, p in model.named_parameters()}
    audio = _audio(n)
    sep = StreamingSeparator(model, HOP, CONTEXT, num_streams=n)
    assert sep.lookahead == model.n_least_samples_req == 40
    for t, out in enumerate(_stream(sep, audio)):
        assert out.shape == (n, 2, HOP) and out.dtype == np.float32
        x = torch.from_numpy(ref.windows(audio, t, HOP, WINDOW))[:, None]
        if t < WINDOW // HOP - 1:
            assert (x[..., : WINDOW - (t + 1) * HOP] == 0).all()  # cold: zeros ahead
        with torch.no_grad():
            want = ref.emitted(ref.forward(w, HP, x), HOP, sep.lookahead).numpy()
        np.testing.assert_allclose(out, want, **TOL, err_msg=f"step {t}")


@pytest.mark.parametrize("n", [1, 3, 16])
def test_a_step_is_the_models_batched_forward(n):
    """Bit for bit: a step emits the slice of the model's own forward over
    the N windows stacked as one batch; the separator adds no arithmetic."""
    model = _model()
    audio = _audio(n, seed=6)
    sep = StreamingSeparator(model, HOP, CONTEXT, num_streams=n)
    for t, out in enumerate(_stream(sep, audio)):
        x = torch.from_numpy(ref.windows(audio, t, HOP, WINDOW))[:, None]
        with torch.no_grad():
            want = ref.emitted(model(x), HOP, sep.lookahead).numpy()
        np.testing.assert_array_equal(out, want, err_msg=f"step {t}")


@pytest.mark.parametrize("n", [3, 16])
def test_each_stream_is_a_single_stream_separator(n):
    """Stream i of an N-stream separator emits what a single-stream
    separator fed stream i's audio alone emits, within TOL: a library
    convolution may sum a batch of N in another order than a batch of one
    (here a 1x1 conv with a bias at N = 16 moves results by ~1e-7
    relative), and nothing else differs."""
    model = _model()
    audio = _audio(n, seed=2)
    multi = _stream(StreamingSeparator(model, HOP, CONTEXT, num_streams=n), audio)
    for i in range(n):
        alone = StreamingSeparator(model, HOP, CONTEXT)
        for t, out in enumerate(multi):
            np.testing.assert_allclose(alone.push(audio[i, t * HOP:(t + 1) * HOP]), out[i],
                                       **TOL)


def test_streams_do_not_leak_into_each_other():
    model = _model()
    audio = _audio(4, seed=3)
    changed = audio.copy()
    changed[2] = 3.0 * _audio(1, seed=4)[0]
    a = np.stack(_stream(StreamingSeparator(model, HOP, CONTEXT, num_streams=4), audio))
    b = np.stack(_stream(StreamingSeparator(model, HOP, CONTEXT, num_streams=4), changed))
    others = [0, 1, 3]
    np.testing.assert_array_equal(a[:, others], b[:, others])
    assert np.abs(a[:, 2] - b[:, 2]).min(axis=-1).max() > 0


def test_a_flat_push_with_one_stream():
    """A 1-D hop with one stream gives (S, hop), the (1, hop) push's row."""
    model = _model()
    audio = _audio(1, seed=5)
    flat = StreamingSeparator(model, HOP, CONTEXT)
    rows = StreamingSeparator(model, HOP, CONTEXT, num_streams=1)
    for t in range(STEPS):
        hop = audio[0, t * HOP:(t + 1) * HOP]
        a, b = flat.push(hop), rows.push(hop[None])
        assert a.shape == (2, HOP) and b.shape == (1, 2, HOP)
        np.testing.assert_array_equal(a, b[0])


@pytest.mark.parametrize("kwargs,hop_shape,match", [
    (dict(num_streams=0), None, "num_streams"),
    (dict(num_streams=-2), None, "num_streams"),
    (dict(context_samples=20, lookahead_samples=40), None, "lookahead"),
    (dict(num_streams=3), (HOP,), r"\(3, 40\)"),
    (dict(num_streams=3), (2, HOP), r"\(3, 40\)"),
    (dict(num_streams=3), (3, HOP + 1), r"\(3, 40\)"),
    (dict(num_streams=1), (HOP - 1,), "exactly 40"),
    (dict(num_streams=1), (2, HOP), "exactly 40"),
])
def test_value_errors(kwargs, hop_shape, match):
    model = _model()
    args = {"hop_samples": HOP, "context_samples": CONTEXT, **kwargs}
    if hop_shape is None:
        with pytest.raises(ValueError, match=match):
            StreamingSeparator(model, **args)
        return
    sep = StreamingSeparator(model, **args)
    with pytest.raises(ValueError, match=match):
        sep.push(np.zeros(hop_shape, np.float32))


@pytest.mark.parametrize("n", [1, 5])
def test_counters(n):
    """``StreamingSeparator.steps`` counts pushes; ``CausalConv1d.mask_applies``
    counts 1 + blocks x depth weight-mask multiplies a forward (the encoder
    and every depthwise conv; the 1x1 convs are not masked)."""
    model = _model()
    sep = StreamingSeparator(model, HOP, CONTEXT, num_streams=n)
    steps, masks = StreamingSeparator.steps, CausalConv1d.mask_applies
    _stream(sep, _audio(n), steps=3)
    assert StreamingSeparator.steps - steps == 3
    per_forward = 1 + HP["num_blocks"] * HP["upsampling_depth"]
    assert CausalConv1d.mask_applies - masks == 3 * per_forward
    with torch.no_grad():
        model(torch.zeros(2, 1, 300))
    assert CausalConv1d.mask_applies - masks == 4 * per_forward


def test_spans_of_a_step():
    """Under a profiler each push is one ``stream.step`` root (attrs
    ``streams``, ``hop``) over ``stream.upload``, ``stream.roll``, the
    causal ``forward`` (``forward.encode``, a ``forward.block`` a block,
    ``forward.decode``) and ``stream.fetch``; outside one nothing is
    recorded."""
    model = _model()
    sep = StreamingSeparator(model, HOP, CONTEXT, num_streams=3)
    audio = _audio(3)
    tracing.clear()
    try:
        _stream(sep, audio, steps=2)
        assert tracing.spans() == []
        with profile(activities=[ProfilerActivity.CPU]):
            _stream(sep, audio, steps=3)
        recs = tracing.spans()
        roots = [r for r in recs if r.parent == 0]
        assert [r.name for r in roots] == ["stream.step"] * 3
        assert all(r.attrs == {"streams": 3, "hop": HOP} for r in roots)
        by_id = {r.id: r for r in recs}
        for root in roots:
            kids = sorted((r for r in recs if r.parent == root.id), key=lambda r: r.start_ns)
            assert [r.name for r in kids] == ["stream.upload", "stream.roll", "forward",
                                              "stream.fetch"]
            fwd = kids[2]
            assert fwd.attrs == {"rows": 3}
            inner = sorted((r for r in recs if r.parent == fwd.id), key=lambda r: r.start_ns)
            assert [r.name for r in inner] == (["forward.encode"]
                                               + ["forward.block"] * HP["num_blocks"]
                                               + ["forward.decode"])
            assert all(by_id[r.parent].request == root.id for r in inner)
    finally:
        tracing.clear()


# -------------------------------------------------------------------- card


@pytest.fixture
def card(monkeypatch):
    """A CUDA card with fp32 as fp32 (no TF32 in cuBLAS or cuDNN) and cuDNN's
    deterministic algorithms, or a skip. By default cuDNN's transposed conv
    (the decoder) may sum with atomics, so two eager forwards of one window
    can differ by an ulp at a few outputs; a bit-for-bit comparison needs
    the sums in one order."""
    if not torch.cuda.is_available():
        pytest.skip("a step's CUDA graphs need a card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    return torch.device("cuda")


# toy widths at 1 and 16 streams; the benchmark cell's model (the class
# defaults, gains 0.2), hop, context and 16 streams
CARD_CASES = [(HP, HOP, CONTEXT, 1), (HP, HOP, CONTEXT, 16), ({}, 160, 3200, 16)]


@pytest.mark.card
@pytest.mark.parametrize("hp,hop,context,n", CARD_CASES)
def test_replayed_steps_are_the_eager_forward(card, hp, hop, context, n):
    """On a card a step replays the captured stages: bit for bit the slice
    of the eager forward over the same windows, with an eager step's spans,
    and the mask multiplies each replay runs counted (the first push runs
    one eager forward before the capture, then the replay)."""
    model = models.get_model("causal", **hp, generator=torch.Generator().manual_seed(3),
                             device=card)
    with torch.no_grad():
        for blk in model.sm:
            blk.skipinit_gain.fill_(0.2)
    model.eval()
    window = hop + context
    audio = _audio(n, seed=8, length=12 * hop)
    sep = StreamingSeparator(model, hop, context, num_streams=n)
    per_forward = 1 + model.num_blocks * model.upsampling_depth
    masks = CausalConv1d.mask_applies
    tracing.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            outs = [sep.push(ref.windows(audio, t, hop, hop)) for t in range(8)]
        recs = list(tracing.spans())
    finally:
        tracing.clear()
    assert sep._graphs is not None
    assert CausalConv1d.mask_applies - masks == 9 * per_forward
    for t, out in enumerate(outs):
        x = torch.from_numpy(ref.windows(audio, t, hop, window))[:, None].to(card)
        with torch.inference_mode():
            want = ref.emitted(model(x), hop, sep.lookahead).cpu().numpy()
        np.testing.assert_array_equal(out, want, err_msg=f"step {t}")
    forwards = [r for r in recs if r.name == "forward"]
    assert len(forwards) == 9  # the eager forward before the capture, 8 replays
    inner = sorted((r for r in recs if r.parent == forwards[-1].id), key=lambda r: r.start_ns)
    assert [r.name for r in inner] == (["forward.encode"] + ["forward.block"] * model.num_blocks
                                       + ["forward.decode"])
