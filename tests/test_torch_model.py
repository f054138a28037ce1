"""The port's Improved SuDoRM-RF against the JAX package, on the CPU.

Both packages get the same weights (the JAX init, loaded into the port with
``convert.load_jax_params``) and the same numpy input. The JAX serving
forward runs its Pallas kernel in interpret mode. Tolerances: rtol 1e-4,
atol 1e-5, as in tests/test_pallas_uconv.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sudo_rm_rf_tpu import models as jmodels
from sudo_rm_rf_tpu.models.fast_inference import improved_forward_fast as jax_fast
from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.convert import load_jax_params
from sudo_rm_rf_tpu_torch.models.fast_inference import improved_forward_fast

TOY = dict(out_channels=32, in_channels=64, num_blocks=2, upsampling_depth=3,
           enc_kernel_size=21, enc_num_basis=24, num_sources=2)
# the published U16/512 widths, cut to 2 blocks
FULL_WIDTH = dict(out_channels=256, in_channels=512, num_blocks=2,
                  upsampling_depth=5, enc_kernel_size=21, enc_num_basis=512,
                  num_sources=2)
CASES = {"toy": (TOY, 661), "full_width": (FULL_WIDTH, 997)}


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    """(params as numpy, input, JAX model.apply output, JAX fast-path output
    with the Pallas kernel in interpret mode)."""
    hp, length = CASES[case]
    x = np.random.default_rng(3).standard_normal((2, 1, length)).astype(np.float32)
    model = jmodels.SuDORMRFImproved(**hp)
    variables = model.init(jax.random.key(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    fast = np.asarray(jax_fast(
        variables["params"], jnp.asarray(x), num_blocks=hp["num_blocks"],
        upsampling_depth=hp["upsampling_depth"], enc_kernel_size=hp["enc_kernel_size"],
        num_sources=hp["num_sources"], impl="pallas", interpret=True))
    return params, x, want, fast


def _port(case, block_impl="xla"):
    hp, _ = CASES[case]
    params = _jax_case(case)[0]
    return load_jax_params(models.get_model("relu", **hp, block_impl=block_impl), params)


@pytest.mark.parametrize("block_impl", ["xla", "fma", "kernel"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_model_forward_matches_jax(case, block_impl):
    _, x, want, _ = _jax_case(case)
    model = _port(case, block_impl)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl", ["kernel", "fma", "xla"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_improved_forward_fast_matches_jax(case, impl):
    _, x, want, fast = _jax_case(case)
    got = improved_forward_fast(_port(case), torch.from_numpy(x), impl=impl).numpy()
    np.testing.assert_allclose(got, fast, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_state_dict_names_are_the_torch_reference_names():
    model = models.get_model("relu", **TOY)
    keys = set(model.state_dict())
    for key in ("encoder.weight", "ln.gamma", "ln.beta", "bottleneck.weight",
                "bottleneck.bias", "sm.0.proj_1x1.conv.weight",
                "sm.0.proj_1x1.norm.gamma", "sm.0.proj_1x1.act.weight",
                "sm.1.spp_dw.2.conv.bias", "sm.1.spp_dw.2.norm.beta",
                "sm.0.final_norm.act.weight", "sm.0.res_conv.weight",
                "mask_net.0.weight", "mask_net.1.bias", "decoder.weight"):
        assert key in keys, key
    assert "encoder.bias" not in keys and "decoder.bias" not in keys
    assert model.state_dict()["sm.0.proj_1x1.act.weight"].shape == (1,)


def test_init_is_seeded_by_the_generator():
    make = lambda seed: models.get_model(
        "relu", **TOY, generator=torch.Generator().manual_seed(seed)).state_dict()
    a, b, c = make(5), make(5), make(6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["sm.0.proj_1x1.conv.weight"], c["sm.0.proj_1x1.conv.weight"])


def test_improved_forward_fast_rejects_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        improved_forward_fast(models.get_model("relu", **TOY), torch.zeros(1, 1, 320),
                              impl="pallas")
