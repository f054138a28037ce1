"""The port's time-sharded GroupComm, causal and attentive forwards
(``inference/sequence_parallel.py``) against the JAX package's, on the CPU.

Sizes are JAX's (tests/test_sequence_parallel.py:235-236, :292-293,
:383-384): out 16, in 32 (GroupComm: out 32, in 64, group 4), 2 blocks, depth
3, encoder kernel 17, 16 bases; attentive at 2 heads of 16 dims, dropout 0.
One case a family (attentive v1 and v2) on JAX's ``make_seq_mesh(2)``
against the port's ``LocalShards(2)``, both with the same params and numpy
inputs; the port's ``LocalShards(n)``, n in {1, 2, 4, 8}, against its own
unsharded forward. The params are the port's seeded init, handed to JAX as
its param tree (``convert.params_to_flax``, the inverse of
``load_jax_params``): no JAX init compiles. The causal models' skip-init
gains are set nonzero, as JAX's test does. Tolerances are JAX's: rtol
1e-3, atol 1e-4 (tests/test_sequence_parallel.py:63-64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sudo_rm_rf_tpu.inference import sequence_parallel as jsp
from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.convert import params_to_flax
from sudo_rm_rf_tpu_torch.inference import sequence_parallel as sp
from sudo_rm_rf_tpu_torch.models.fast_inference import groupcomm_forward_fast

CFG = dict(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=3,
           enc_kernel_size=17, enc_num_basis=16, num_sources=2)
ATT = dict(n_heads=2, att_dims=16, att_dropout=0.0, hardcode_block_attention=False)
FAMILIES = {
    # name: (model type, extra hparams, port forward, JAX forward, halo rule)
    "groupcomm_v2": ("groupcomm_v2", dict(out_channels=32, in_channels=64, group_size=4),
                     sp.groupcomm_forward_seq, jsp.groupcomm_forward_seq,
                     sp.default_halo_frames),
    "causal": ("causal", {}, sp.causal_forward_seq, jsp.causal_forward_seq,
               sp.causal_halo_frames),
    "attention": ("attention", ATT, sp.attentive_forward_seq, jsp.attentive_forward_seq,
                  sp.default_halo_frames),
    "attention_v2": ("attention_v2", ATT, sp.attentive_forward_seq,
                     jsp.attentive_forward_seq, sp.default_halo_frames),
}
TOL = dict(rtol=1e-3, atol=1e-4)
STRIDE = CFG["enc_kernel_size"] // 2
ALIGN = STRIDE * 2 ** CFG["upsampling_depth"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for these tiny tensors: in a loaded parallel run
    torch's default pool oversubscribes the cores and every small op waits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hp(name):
    return dict(CFG, **FAMILIES[name][1])


def _per(halo):
    return -(-max(halo * STRIDE, 3 * ALIGN) // ALIGN) * ALIGN


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port(name, seed):
    """The port's model drawn from its own generator at ``seed``; causal
    skip-init gains set to 0.5 + 0.1 i (at 0 every block passes its input
    through)."""
    model = models.get_model(FAMILIES[name][0], **_hp(name),
                             generator=torch.Generator().manual_seed(seed))
    if name == "causal":
        with torch.no_grad():
            for i, blk in enumerate(model.sm):
                blk.skipinit_gain.fill_(0.5 + 0.1 * i)
    return model.eval()


def _halo(name):
    return FAMILIES[name][4](CFG["num_blocks"], CFG["upsampling_depth"])


def _jax_kwargs(name):
    kw = dict(num_blocks=CFG["num_blocks"], depth=CFG["upsampling_depth"],
              enc_kernel_size=CFG["enc_kernel_size"], num_sources=2)
    if name == "groupcomm_v2":
        kw["group_size"] = 4
    if name.startswith("attention"):
        kw.update(n_heads=ATT["n_heads"], variant="v1" if name == "attention" else "v2")
    return kw


def _unsharded(name, model, x):
    if name == "groupcomm_v2":
        return groupcomm_forward_fast(model, x[:, None], impl="fma_merged")
    with torch.no_grad():
        return model(x[:, None])


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_forward_seq_matches_jax(name):
    """One case a family on a 2-device JAX mesh."""
    model = _port(name, seed=0)
    x = _rand((2, 2 * _per(_halo(name))), 7)
    want = np.asarray(FAMILIES[name][3](params_to_flax(model), jnp.asarray(x),
                                        jsp.make_seq_mesh(2), **_jax_kwargs(name)))
    got = FAMILIES[name][2](model, torch.from_numpy(x), sp.LocalShards(2))
    assert got.shape == want.shape == (2, 2, x.shape[1])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_local_shards_equal_the_unsharded_forward(name, n):
    model = _port(name, seed=n)
    x = torch.from_numpy(_rand((2, 8 * _per(_halo(name))), n))
    got = FAMILIES[name][2](model, x, sp.LocalShards(n))
    np.testing.assert_allclose(got.numpy(), _unsharded(name, model, x).numpy(), **TOL)


def test_causal_too_small_halo_must_break():
    """A halo below the causal receptive field is not exact: the test above
    is not vacuous."""
    model = _port("causal", seed=1)
    small = 4  # far below num_blocks * 10 * 2**depth
    x = torch.from_numpy(_rand((1, 8 * _per(small)), 10))
    want = _unsharded("causal", model, x)
    got = sp.causal_forward_seq(model, x, sp.LocalShards(8), halo_frames=small)
    assert (got - want).abs().max() > 1e-3


@pytest.mark.parametrize("name", ["groupcomm_v2", "causal", "attention_v2"])
def test_separator_arbitrary_length(name):
    """The separator at an unaligned length equals the unsharded forward on
    the identically padded input (no normalization)."""
    model = _port(name, seed=0)
    sep = sp.SequenceParallelSeparator(model, sp.LocalShards(4), input_normalize=False,
                                       mixture_consistency=None)
    assert sep.model_type == name
    t = 5000 + 37
    x = _rand(t, 3)
    got = sep.separate(x)
    padded = np.zeros(sep._padded_len(t), np.float32)
    padded[:t] = x
    want = _unsharded(name, model, torch.from_numpy(padded)[None])[0, :, :t]
    assert got.shape == (2, t) and sep.route == "fma"
    np.testing.assert_allclose(got, want.numpy(), **TOL)


def test_groupcomm_separator_mixture_consistency():
    sep = sp.SequenceParallelSeparator(_port("groupcomm_v2", seed=0), sp.LocalShards(4),
                                       mixture_consistency="uniform")
    mixture = _rand(9000 + 11, 8)
    mixture -= mixture.mean()
    est = sep.separate(mixture)
    assert est.shape == (2, 9011) and np.isfinite(est).all()
    assert np.abs(mixture - est.sum(axis=0)).max() < 5e-3


@pytest.mark.parametrize("model_type", ["attention_v3", "softmax"])
def test_unsupported_models_refused_with_the_reason(model_type):
    model = models.get_model(model_type, **CFG)
    with pytest.raises(ValueError, match="falls back to overlap-add"):
        sp.SequenceParallelSeparator(model)
    if model_type == "attention_v3":
        with pytest.raises(ValueError, match="per-block gather would move"):
            sp.attentive_forward_seq(model, torch.zeros(1, 2 * _per(16)), sp.LocalShards(2))


def test_groupcomm_multichannel_refused():
    model = models.get_model("groupcomm_v2", **_hp("groupcomm_v2"), in_audio_channels=2)
    with pytest.raises(ValueError, match="in_audio_channels=1"):
        sp.groupcomm_forward_seq(model, torch.zeros(1, 2 * _per(20)), sp.LocalShards(2))
