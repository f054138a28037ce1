"""TAC's two forms (``ops/tac.py``) and GroupComm's routing between them.

On the CPU: ``fused_tac`` runs its plain version, which equals ``_tac_fast``
and the benchmark's plain reference (``perfbench/reference/groupcomm.py::
tac``, the published concatenate form) at 4, 8 and 16 channels a group and a
ragged length; every GroupComm serving impl counts one TAC a block; the
'kernel' impl routes an fp32 stream to the fused TAC (the ``forward.tac``
span's ``fused``) and a bf16 stream or a group wider than ``TAC_MAX_N`` to
the plain one.

On a card (``card``: skip without one): the Hopper kernel against the plain
version at the serving cell's shape, the 10-minute shape (three launches,
its tiles merged by a fold launch) and narrow groups with a ragged length;
two calls bit-identical; the 'kernel' forward at the cell's shape against
the reference. Run there with ``python -m pytest --noconftest
tests/test_torch_tac.py -m card`` (tests/conftest.py imports JAX).

Tolerance: rtol 1e-4, atol 1e-5, as tests/test_torch_groupcomm.py holds the
port to the JAX package. The forms differ only in the order of their fp32
sums (the group mean, the split output Linear, GlobLN's moments merged in
float64), about 1e-6 relative.
"""

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sudo_rm_rf_tpu_torch.models import GroupCommSuDORMRF
from sudo_rm_rf_tpu_torch.models import groupcomm_sudormrf as gc
from sudo_rm_rf_tpu_torch.models.fast_inference import GC_IMPLS, groupcomm_forward_fast
from sudo_rm_rf_tpu_torch.ops import tac as T
from sudo_rm_rf_tpu_torch.utils import tracing
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.reference import groupcomm as ref  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
HP = dict(in_audio_channels=1, out_channels=32, in_channels=64, num_blocks=3,
          upsampling_depth=3, enc_kernel_size=21, enc_num_basis=24, num_sources=2,
          group_size=4)
# the serving cell's model (perfbench/configs/groupcomm_u16_b512.json)
CELL = dict(in_audio_channels=1, out_channels=256, in_channels=512, num_blocks=16,
            upsampling_depth=5, enc_kernel_size=21, enc_num_basis=512, num_sources=2,
            group_size=16)


def _tac(n, seed=0, device="cpu"):
    """A TAC module of n channels a group from a seeded init, its slopes,
    gains and shifts drawn around their init so that no leaf is trivial."""
    g = torch.Generator().manual_seed(seed)
    tac = gc.TAC(n, 3 * n, generator=g).eval()
    with torch.no_grad():
        for name, p in tac.named_parameters():
            if name.endswith(("gamma", "beta")) or p.numel() == 1:
                p.add_(0.1 * (2 * torch.rand(p.shape, generator=g) - 1))
    return tac.to(device)


def _x(shape, seed=1, device="cpu"):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(device)


def _reference_tac(tac, x):
    b, g, n, t = x.shape
    w = {k: p.detach() for k, p in tac.named_parameters()}
    return ref.tac(w, "", x.reshape(b, g * n, t), g).reshape(b, g, n, t)


def _model(hp, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return GroupCommSuDORMRF(**hp, generator=g).eval().to(device)


@pytest.fixture
def no_spans():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture
def card(monkeypatch):
    """A CUDA card with fp32 as fp32 (no TF32 in cuBLAS or cuDNN), or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("the fused TAC is a CUDA kernel: needs a card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return "cuda"


# --------------------------------------------------------------------- CPU


@pytest.mark.parametrize("n", [4, 8, 16])
def test_fused_tac_on_the_cpu_is_the_plain_tac_and_the_reference(n):
    tac = _tac(n, seed=n)
    x = _x((3, 5, n, 37))
    calls = gc._tac_fast.calls
    with torch.no_grad():
        got = T.fused_tac(tac, x)
        plain = gc._tac_fast(tac, x)
    assert gc._tac_fast.calls - calls == 1
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    torch.testing.assert_close(got, _reference_tac(tac, x), **TOL)


@pytest.mark.parametrize("fault", ["none", "shape", "device", "dtype", "grad"])
def test_tac_param_check_runs_on_cpu_tensors(fault):
    """TAC's param table through the launch's shared check
    (``_build.check_params``), which runs before any launch: a module of
    another width than x's groups, a param on another device than x and a
    param that would need a gradient each raise with the wrapper's name; a
    float64 param is read as float32, in the order of the C entry point."""
    tac, x = _tac(8 if fault == "shape" else 4), _x((2, 3, 4, 37))
    if fault == "device":
        tac.TAC_norm.beta = torch.nn.Parameter(tac.TAC_norm.beta.detach().to("meta"))
    elif fault == "dtype":
        tac.double()
    raises = {
        "shape": (ValueError, r"fused_tac: param w_in must be a \(12, 4\) tensor on cpu"),
        "device": (ValueError, "fused_tac: param beta .* on meta"),
        "grad": (RuntimeError, "fused_tac has no backward"),
    }
    if fault in raises:
        err, match = raises[fault]
        with torch.set_grad_enabled(fault == "grad"), pytest.raises(err, match=match):
            T._checked_params(tac, x)
        return
    with torch.no_grad():
        got = T._checked_params(tac, x)
    own = list(tac.parameters())  # the module's order is the entry point's
    assert len(got) == len(own) == 11 and all(p.dtype == torch.float32 for p in got)
    for p, q in zip(got, own):
        assert p is q if fault == "none" else torch.equal(p, q.float())


@pytest.mark.parametrize("impl", GC_IMPLS)
def test_every_impl_counts_one_tac_a_block(impl):
    model = _model(HP)
    x = _x((2, 1, 640))
    calls, launches = gc._tac_fast.calls, T.fused_tac.launches
    groupcomm_forward_fast(model, x, impl=impl)
    assert gc._tac_fast.calls - calls == HP["num_blocks"]
    assert T.fused_tac.launches == launches  # the CPU runs the plain version


@pytest.mark.parametrize("impl, compute_dtype, fused", [
    ("kernel", None, [1, 1, 1]),
    ("kernel", "bfloat16", [0, 1, 1]),  # a bf16 stream up to the first K1 call
    ("fma_merged", None, [0, 0, 0]),
    ("xla", None, [0, 0, 0]),
    # only 'kernel' routes to the fused TAC, whatever the dtype
    ("fma_merged", "bfloat16", [0, 0, 0]),
    ("xla", "bfloat16", [0, 0, 0]),
])
def test_forward_tac_spans_carry_the_route(impl, compute_dtype, fused, no_spans):
    model = _model(HP)
    x = _x((2, 1, 640))
    launches = T.fused_tac.launches
    with profile(activities=[ProfilerActivity.CPU]):
        groupcomm_forward_fast(model, x, impl=impl, compute_dtype=compute_dtype)
    tacs = sorted((r for r in tracing.spans() if r.name == "forward.tac"),
                  key=lambda r: r.start_ns)
    assert [r.attrs for r in tacs] == [{"fused": f} for f in fused]
    assert T.fused_tac.launches == launches


def test_a_group_wider_than_the_kernel_takes_the_plain_tac(no_spans):
    n = T.TAC_MAX_N + 4
    hp = dict(HP, out_channels=n, in_channels=8, num_blocks=1, upsampling_depth=2,
              group_size=1)
    with profile(activities=[ProfilerActivity.CPU]):
        groupcomm_forward_fast(_model(hp), _x((1, 1, 320)), impl="kernel")
    assert [r.attrs for r in tracing.spans() if r.name == "forward.tac"] == [{"fused": 0}]


def test_the_kernel_forward_on_the_cpu_matches_the_reference():
    model = _model(HP)
    x = _x((2, 1, 1601))
    want = ref.forward({k: p.detach() for k, p in model.named_parameters()}, HP, x)
    torch.testing.assert_close(groupcomm_forward_fast(model, x, impl="kernel"), want, **TOL)


# -------------------------------------------------------------------- card

# (B, G, n, T): the serving cell's TAC, the 10-minute pass's (7,500 tiles a
# plane: the fold launch), narrow groups with T past a whole tile and odd
CARD_SHAPES = [(32, 16, 16, 3200), (1, 16, 16, 480000), (3, 8, 4, 1037), (2, 4, 8, 777),
               (2, 8, 32, 1001)]


@pytest.mark.card
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_the_plain_version_and_repeats_bit_for_bit(shape, card):
    b, g, n, t = shape
    tac = _tac(n, seed=n, device=card)
    x = _x(shape, device=card)
    from sudo_rm_rf_tpu_torch.ops._build import load_kernels

    tiles = load_kernels().tac_tiles(t)
    with torch.no_grad():
        launches = T.fused_tac.launches
        got = T.fused_tac(tac, x)
        torch.cuda.synchronize()
        assert T.fused_tac.launches - launches == (3 if tiles > 256 else 2)
        torch.testing.assert_close(got, T.tac_plain(tac, x), **TOL)
        assert torch.equal(got, T.fused_tac(tac, x))
    if shape == (1, 16, 16, 480000):
        assert tiles > 256  # this shape takes the fold launch


@pytest.mark.card
def test_kernel_forward_at_the_cell_shape_matches_the_reference(card):
    model = _model(CELL, seed=3, device=card)
    x = _x((32, 1, 32000), seed=4, device=card)
    calls, launches = gc._tac_fast.calls, T.fused_tac.launches
    got = groupcomm_forward_fast(model, x, impl="kernel")
    assert gc._tac_fast.calls - calls == CELL["num_blocks"]
    assert T.fused_tac.launches - launches == 2 * CELL["num_blocks"]
    with torch.no_grad():
        want = ref.forward({k: p.detach() for k, p in model.named_parameters()}, CELL, x)
    # the benchmark's measure: the worst relative L2 error of one source of one row
    rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
    assert rel <= 5e-6, rel
