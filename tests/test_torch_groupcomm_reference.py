"""The port's GroupComm SuDoRM-RF v2 against the benchmark's plain reference
(``perfbench/reference/groupcomm.py``: plain PyTorch, TAC in its published
concatenate form), on the CPU at toy widths and odd lengths with seeded
random weights; and the serving forward's spans and TAC counter.

Tolerance: rtol 1e-4, atol 1e-5, as tests/test_torch_groupcomm.py holds the
port to the JAX package. Both sides run in fp32 and differ only in the order
of their sums: the port splits TAC's output Linear (``_tac_fast``), folds
GlobLN into scale and shift in one pass, and merges the groups into the
channel axis ('fma_merged'); such reorderings move fp32 results by about
1e-6 relative.
"""

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sudo_rm_rf_tpu_torch.models import GroupCommSuDORMRF
from sudo_rm_rf_tpu_torch.models import groupcomm_sudormrf as gc
from sudo_rm_rf_tpu_torch.models.fast_inference import GC_IMPLS, groupcomm_forward_fast
from sudo_rm_rf_tpu_torch.utils import tracing
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.reference import groupcomm as ref  # noqa: E402

HP = dict(in_audio_channels=1, out_channels=32, in_channels=64, num_blocks=2,
          upsampling_depth=3, enc_kernel_size=21, enc_num_basis=24, num_sources=2,
          group_size=4)
STEREO = dict(HP, in_audio_channels=2, num_sources=3, group_size=8)
TOL = dict(rtol=1e-4, atol=1e-5)


def _model(hp, seed=0, block_impl="xla"):
    """The port's model from a seeded init, with its norms' gains and
    shifts and its PReLU slopes drawn around their init too, so that every
    leaf the reference reads differs from its neighbours."""
    g = torch.Generator().manual_seed(seed)
    model = GroupCommSuDORMRF(**hp, block_impl=block_impl, generator=g).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("gamma", "beta")) or (p.ndim == 1 and p.numel() == 1):
                p.add_(0.1 * (2 * torch.rand(p.shape, generator=g) - 1))
    return model


def _weights(model):
    return {n: p.detach() for n, p in model.named_parameters()}


def _mixture(b, channels, n, seed=1):
    return torch.randn((b, channels, n), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("n_samples", [1601, 3217])
@pytest.mark.parametrize("block_impl", ["xla", "fma"])
def test_module_forward_matches_the_reference(block_impl, n_samples):
    model = _model(HP, block_impl=block_impl)
    x = _mixture(3, 1, n_samples)
    with torch.no_grad():
        got = model(x)
    want = ref.forward(_weights(model), HP, x)
    assert got.shape == want.shape == (3, 2, n_samples)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("n_samples", [1601, 3217])
@pytest.mark.parametrize("impl", GC_IMPLS)
def test_groupcomm_forward_fast_matches_the_reference(impl, n_samples, monkeypatch):
    device = "cpu"
    if impl == "kernel":
        if not torch.cuda.is_available():
            pytest.skip("the kernel impl launches K1, a CUDA kernel: needs a card")
        device = "cuda"
        # fp32 as fp32 on both sides: no TF32 in cuBLAS or cuDNN
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    model = _model(HP).to(device)
    x = _mixture(3, 1, n_samples).to(device)
    got = groupcomm_forward_fast(model, x, impl=impl)
    want = ref.forward(_weights(model), HP, x)
    assert got.shape == want.shape == (3, 2, n_samples)
    torch.testing.assert_close(got.cpu(), want.cpu(), **TOL)


@pytest.mark.parametrize("impl", ["fma_merged", "xla"])
def test_multichannel_matches_the_reference(impl):
    model = _model(STEREO, seed=4)
    x = _mixture(2, 2, 2411, seed=5)
    want = ref.forward(_weights(model), STEREO, x)
    assert want.shape == (2, 6, 2411)
    with torch.no_grad():
        torch.testing.assert_close(model(x), want, **TOL)
    torch.testing.assert_close(groupcomm_forward_fast(model, x, impl=impl), want, **TOL)


def test_the_reference_tac_is_the_modules():
    """The concatenate form against the port's module TAC on one block."""
    model = _model(HP, seed=7)
    b, c, t = 2, HP["out_channels"], 40
    x = torch.randn((b, c, t), generator=torch.Generator().manual_seed(8))
    g = HP["group_size"]
    with torch.no_grad():
        want = model.sm[0].TAC(x.reshape(b, g, c // g, t)).reshape(b, c, t)
    torch.testing.assert_close(ref.tac(_weights(model), "sm.0.TAC.", x, g), want, **TOL)


@pytest.fixture
def no_spans():
    tracing.clear()
    yield
    tracing.clear()


def test_forward_records_encode_tac_blocks_and_decode(no_spans):
    hp = dict(HP, num_blocks=16)
    model = _model(hp)
    x = _mixture(2, 1, 800)
    calls = gc._tac_fast.calls
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            groupcomm_forward_fast(model, x, impl="fma_merged")
    assert gc._tac_fast.calls - calls == 2 * hp["num_blocks"]
    recs = tracing.spans()
    roots = [r for r in recs if r.parent == 0]
    assert [r.name for r in roots] == ["forward"] * 2
    for root in roots:
        assert root.attrs == {"rows": 2}
        kids = sorted((r for r in recs if r.request == root.id and r is not root),
                      key=lambda r: r.start_ns)
        assert [r.name for r in kids] == (["forward.encode"]
                                          + ["forward.tac", "forward.block"] * 16
                                          + ["forward.decode"])
        assert all(r.parent == root.id for r in kids)
        assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns for r in kids)


def test_no_span_without_a_profiler_and_tac_still_counted(no_spans):
    model = _model(HP)
    calls = gc._tac_fast.calls
    groupcomm_forward_fast(model, _mixture(2, 1, 800), impl="fma_merged")
    assert tracing.spans() == []
    assert gc._tac_fast.calls - calls == HP["num_blocks"]
