"""The port's causal SuDoRM-RF v3 and its streaming separator against the
JAX package, on the CPU.

Toy hparams of tests/test_registry_smoke.py (out 16, in 32, one block,
depth 2, basis 16) and a two-block two-channel case; odd lengths;
numpy-seeded inputs; the JAX init, with every ``skipinit_gain`` set to a
non-zero value (a fresh model's blocks pass their input through unchanged),
loaded into the port with ``convert.load_jax_params``. Tolerances as
tests/_torch_zoo_parity.py states; streaming: port and JAX equal within
1e-5, streamed and offline within rtol 1e-4, atol 1e-5 outside the head
and tail regions, emission stability bit-equal.
"""

import functools

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo_parity import (
    assert_checkpoints_round_trip,
    assert_forward_matches,
    assert_grads_match,
    assert_separate_cli_matches_jax,
    assert_train_step_matches,
    brown_sources,
    jax_init,
    rand,
)
from sudo_rm_rf_tpu import models as jmodels
from sudo_rm_rf_tpu.inference.streaming import StreamingSeparator as JaxStreaming
from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.config import ModelConfig
from sudo_rm_rf_tpu_torch.convert import load_jax_params
from sudo_rm_rf_tpu_torch.inference import StreamingSeparator
from sudo_rm_rf_tpu_torch.models.causal_sudormrf import CausalConv1d, causal_mask
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

HP = dict(in_audio_channels=1, out_channels=16, in_channels=32, num_blocks=1,
          upsampling_depth=2, enc_kernel_size=21, enc_num_basis=16, num_sources=2)
CASES = {"mono": HP, "stereo": dict(HP, in_audio_channels=2, num_blocks=2)}
LENGTH = 661


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    """(JAX model, params with the gains set, input) of a case."""
    hp = CASES[case]
    x = rand((2, hp["in_audio_channels"], LENGTH), 3)
    jmodel = jmodels.CausalSuDORMRF(**hp)
    flat = tu.flatten_dict(jax_init(jmodel, x))
    for i, k in enumerate(sorted(flat)):
        if k[-1] == "skipinit_gain":
            flat[k] = np.asarray(0.7 - 0.2 * i, np.float32)
    return jmodel, tu.unflatten_dict(flat), x


def _port(case="mono"):
    _, params, _ = _jax_case(case)
    return load_jax_params(models.get_model("causal", **CASES[case]), params)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    jmodel, params, x = _jax_case(case)
    port = _port(case)
    assert port.state_dict()["sm.0.skipinit_gain"].shape == ()
    assert_forward_matches(jmodel, params, port, x)


@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_jax_and_masked_taps_get_none(case):
    jmodel, params, x = _jax_case(case)
    port = _port(case)
    grads = assert_grads_match(jmodel, params, port, x)
    # the mask is applied inside the forward: a masked tap has zero gradient
    for name, mod in port.named_modules():
        if isinstance(mod, CausalConv1d) and mod.masked:
            future = mod.weight.shape[-1] // 2
            g = grads[f"{name}.weight"]
            assert torch.all(g[..., -future:] == 0) and g[..., :-future].abs().max() > 0, name


def test_causal_mask():
    np.testing.assert_array_equal(causal_mask(5).numpy(), [1, 1, 1, 0, 0])
    np.testing.assert_array_equal(causal_mask(1).numpy(), [1])
    from sudo_rm_rf_tpu.models.causal_sudormrf import _causal_mask

    for k in (1, 3, 21, 41):
        np.testing.assert_array_equal(causal_mask(k).numpy(), np.asarray(_causal_mask(k)))


def test_a_fresh_model_passes_its_blocks_through():
    """skipinit_gain starts at 0: every block returns its input."""
    model = models.get_model("causal", **HP)
    x = torch.from_numpy(rand((2, 16, 40), 4))
    with torch.no_grad():
        assert torch.equal(model.sm[0](x), x)


def test_train_step_matches_jax():
    """With the clamp off: the random causal model's SI-SDR sits at -31 to
    -38 dB on any of the noise batches tried, past the default clamp of 30
    (its mask is not multiplied with the encoder features)."""
    jmodel, params, _ = _jax_case("mono")
    assert_train_step_matches(jmodel, params, _port(), brown_sources(7, 4, 2, 1000),
                              loss_clamp=0.0)


def test_is_causal():
    """Future samples do not move past outputs (as
    tests/test_model_parity.py::test_causal_v3_is_actually_causal holds the
    JAX model)."""
    model = _port()
    x1 = rand((1, 1, 640), 5)
    x2 = x1.copy()
    x2[..., 400:] += 10.0
    with torch.no_grad():
        y1, y2 = (model(torch.from_numpy(v)).numpy() for v in (x1, x2))
    safe = 400 - 2 * HP["enc_kernel_size"] * 2 ** HP["upsampling_depth"]
    np.testing.assert_allclose(y1[..., :safe], y2[..., :safe], atol=1e-5)
    assert np.abs(y1[..., 420:] - y2[..., 420:]).max() > 1e-3


def test_streaming_matches_jax_and_offline():
    """The port's StreamingSeparator against JAX's on the same params
    (within 1e-5), against the port's offline forward outside the head and
    tail regions (as tests/test_graft_entry.py holds JAX's), and emission
    stability: a shorter stream emits bit-identical samples."""
    jmodel, params, _ = _jax_case("mono")
    model = _port()
    mixture = rand((4800,), 6)
    kw = dict(hop_samples=80, context_samples=1600, num_sources=2, lookahead_samples=160)
    sep = StreamingSeparator(model, **kw)
    streamed = sep.separate_stream(mixture)
    want = JaxStreaming(jmodel, jax.tree.map(jnp.asarray, params), **kw).separate_stream(mixture)
    assert streamed.shape == want.shape == (2, 4800)
    np.testing.assert_allclose(streamed, want, rtol=0, atol=1e-5)

    with torch.no_grad():
        offline = model(torch.from_numpy(mixture[None, None])).numpy()[0]
    head, tail = 400, HP["enc_kernel_size"] // 2 + 1
    np.testing.assert_allclose(streamed[:, head:-tail], offline[:, head:-tail],
                               rtol=1e-4, atol=1e-5)
    shorter = sep.separate_stream(mixture[:2400])
    overlap = 2400 - sep.lookahead
    np.testing.assert_array_equal(shorter[:, :overlap], streamed[:, :overlap])


def test_streaming_push_contract():
    model = _port()
    sep = StreamingSeparator(model, hop_samples=160, context_samples=640)
    assert sep.lookahead == model.n_least_samples_req == 40
    out = sep.push(np.zeros(160, np.float32))
    assert out.shape == (2, 160) and out.dtype == np.float32
    with pytest.raises(ValueError, match="exactly 160"):
        sep.push(np.zeros(100, np.float32))
    with pytest.raises(ValueError, match="lookahead"):
        StreamingSeparator(model, hop_samples=160, context_samples=80, lookahead_samples=160)
    # reset clears the window: the same pushes give the same emissions
    sep.reset()
    a = [sep.push(rand((160,), i)) for i in range(4)]
    sep.reset()
    b = [sep.push(rand((160,), i)) for i in range(4)]
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def test_config_builds_causal_with_audio_channels():
    model = ModelConfig(model_type="causal", out_channels=16, in_channels=32, num_blocks=1,
                        upsampling_depth=2, enc_num_basis=16, in_audio_channels=2).build()
    assert model.in_audio_channels == 2 and model.decoder.weight.shape == (64, 4, 21)
    assert model.encoder.weight.shape == (16, 2, 41) and model.encoder.bias is None


def test_separate_cli_matches_jax_cli(tmp_path):
    assert_separate_cli_matches_jax(tmp_path, "causal", HP, _port())


def test_checkpoints_round_trip(tmp_path):
    jmodel, params, x = _jax_case("mono")
    assert_checkpoints_round_trip(tmp_path, "causal", HP, jmodel, params, _port(), x)
