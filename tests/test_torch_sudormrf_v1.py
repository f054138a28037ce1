"""The port's SuDoRM-RF v1 ("softmax") against the JAX package, on the CPU.

Toy hparams of tests/test_registry_smoke.py (out 16, in 32, one block,
depth 2) at basis 24, so that the reshape conv (out_channels !=
enc_num_basis) exists, with S = 2 (softmax over the sources) and S = 1 (the
sigmoid branch); and the registry's basis 16, where it does not; odd lengths, numpy-seeded inputs, the JAX init loaded with
``convert.load_jax_params``. Tolerances as tests/_torch_zoo_parity.py
states; the layers within rtol 1e-5, atol 1e-6.
"""

import functools

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
from sudo_rm_rf_tpu.models import sudormrf as jv1
from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.convert import load_jax_params
from sudo_rm_rf_tpu_torch.models import sudormrf as tv1
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

HP = dict(out_channels=16, in_channels=32, num_blocks=1, upsampling_depth=2,
          enc_kernel_size=21, enc_num_basis=24, num_sources=2)
CASES = {"S2": HP, "S1": dict(HP, num_sources=1),
         "no_reshape": dict(HP, enc_num_basis=16, num_blocks=2)}
LENGTH = 661
LAYER_TOL = dict(rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    x = rand((2, 1, LENGTH), 3)
    jmodel = jmodels.SuDORMRFv1(**CASES[case])
    return jmodel, jax_init(jmodel, x), x


def _port(case="S2"):
    return load_jax_params(models.get_model("softmax", **CASES[case]), _jax_case(case)[1])


@pytest.mark.parametrize("case", ["S2", "S1"])
def test_forward_matches_jax(case):
    jmodel, params, x = _jax_case(case)
    port = _port(case)
    assert port.state_dict()["reshape_before_masks.weight"].shape == (24, 16, 1)
    assert_forward_matches(jmodel, params, port, x)


def test_forward_matches_jax_without_the_reshape_conv():
    jmodel, params, x = _jax_case("no_reshape")
    port = _port("no_reshape")
    assert not hasattr(port, "reshape_before_masks")
    assert_forward_matches(jmodel, params, port, x)


@pytest.mark.parametrize("case", ["S2", "S1"])
def test_grads_match_jax(case):
    jmodel, params, x = _jax_case(case)
    assert_grads_match(jmodel, params, _port(case), x)


def test_train_step_matches_jax():
    jmodel, params, _ = _jax_case("S2")
    assert_train_step_matches(jmodel, params, _port(), brown_sources(7, 4, 2, 1000))


def test_group_norm_eps_is_1e_8():
    """GroupNorm1 is nn.GroupNorm(1, C, eps=1e-8), not the default 1e-5: on
    an input whose variance is near 1e-5 the two part, and the port's agrees
    with JAX's and with torch's at 1e-8."""
    x = rand((2, 6, 50), 1, scale=3e-3)
    norm = tv1.GroupNorm1(6)
    with torch.no_grad():
        norm.weight.copy_(torch.linspace(0.5, 1.5, 6))
        norm.bias.copy_(torch.linspace(-0.1, 0.1, 6))
        got = norm(torch.from_numpy(x))
        ref = torch.nn.GroupNorm(1, 6, eps=1e-8)
        ref.load_state_dict(norm.state_dict())
        np.testing.assert_allclose(got.numpy(), ref(torch.from_numpy(x)).numpy(), **LAYER_TOL)
        ref5 = torch.nn.GroupNorm(1, 6)
        ref5.load_state_dict(norm.state_dict())
        assert np.abs(got.numpy() - ref5(torch.from_numpy(x)).numpy()).max() > 1e-2
    jnorm = jv1.GroupNorm1(6)
    params = {"weight": norm.weight.detach().numpy(), "bias": norm.bias.detach().numpy()}
    want = jnorm.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("n", [16, 15])
def test_mask_conv2d_matches_jax(n):
    """The (N+1, 1) mask conv with height padding N - N//2, at an even and
    an odd N (where the output is one row taller)."""
    x = rand((2, 1, n, 37), 2)
    jm = jv1.MaskConv2d(2, n)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(1), jnp.asarray(x))["params"])
    port = load_jax_params(tv1.MaskConv2d(2, n), params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, n + n % 2, 37)
    np.testing.assert_allclose(got, want, **LAYER_TOL)


def test_per_channel_prelu_and_decoder_layout():
    port = _port()
    sd = port.state_dict()
    assert sd["sm.0.proj_1x1.act.weight"].shape == (32,)
    assert sd["sm.0.module_act.act.weight"].shape == (16,)
    assert sd["decoder.weight"].shape == (48, 1, 21) and sd["decoder.bias"].shape == (2,)
    assert sd["m.weight"].shape == (2, 1, 25, 1) and "encoder.0.bias" in sd
    assert port.lcm == jmodels.SuDORMRFv1(**HP).lcm == 20


def test_published_checkpoint_layout_loads(tmp_path):
    """A ``.pt`` holding v1's dead ``ln_mask_in`` loads strictly through
    ``models.load_checkpoint_model``."""
    port = _port()
    sd = dict(port.state_dict())
    sd["ln_mask_in.weight"] = torch.ones(24)
    sd["ln_mask_in.bias"] = torch.zeros(24)
    torch.save(sd, tmp_path / "v1.pt")
    back = models.load_checkpoint_model("softmax", HP, str(tmp_path / "v1.pt"), "cpu")
    for k, v in port.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


@pytest.mark.parametrize("case", ["S2", "S1"])
def test_separate_cli_matches_jax_cli(tmp_path, case):
    assert_separate_cli_matches_jax(tmp_path, "softmax", CASES[case], _port(case))


def test_checkpoints_round_trip(tmp_path):
    jmodel, params, x = _jax_case("S2")
    assert_checkpoints_round_trip(tmp_path, "softmax", HP, jmodel, params, _port(), x)
