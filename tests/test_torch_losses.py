"""The port's losses against the JAX package's, on the CPU.

Same numpy inputs through both packages; values and gradients (``jax.grad``
against autograd, of the sum of each output weighted by a fixed random
tensor). Tolerances: rtol = atol = 1e-5 on values, 1e-4 on gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sudo_rm_rf_tpu import losses as jl
from sudo_rm_rf_tpu_torch import losses as tl
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _inputs(s, b=3, t=257, seed=0):
    rng = np.random.default_rng(seed)
    tgt = rng.standard_normal((b, s, t)).astype(np.float32)
    est = (0.6 * tgt[:, ::-1] + 0.4 * rng.standard_normal((b, s, t))).astype(np.float32)
    mix = tgt.sum(1, keepdims=True).astype(np.float32)
    return est, tgt, mix


def _jax_value_and_grad(fn, est, weight):
    """fn(est) and d sum(weight * fn(est)) / d est, by JAX."""
    out = np.asarray(fn(jnp.asarray(est)))
    grad = jax.grad(lambda e: jnp.sum(jnp.asarray(weight) * fn(e)))(jnp.asarray(est))
    return out, np.asarray(grad)


def _torch_value_and_grad(fn, est, weight):
    e = torch.tensor(est, requires_grad=True)
    out = fn(e)
    (torch.from_numpy(np.asarray(weight, np.float32)) * out).sum().backward()
    return out.detach().numpy(), e.grad.numpy()


def _check(jfn, tfn, est, out_shape, seed=1):
    weight = np.random.default_rng(seed).standard_normal(out_shape).astype(np.float32)
    jv, jg = _jax_value_and_grad(jfn, est, weight)
    tv, tg = _torch_value_and_grad(tfn, est, weight)
    assert tv.shape == jv.shape == out_shape
    np.testing.assert_allclose(tv, jv, **VAL)
    np.testing.assert_allclose(tg, jg, **GRAD)
    assert np.abs(jg).max() > 0


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("sdr_type", ["sisdr", "sdsdr", "snr"])
def test_pairwise_neg_sdr_matches_jax(sdr_type, s):
    est, tgt, _ = _inputs(s)
    _check(lambda e: jl.pairwise_neg_sdr(e, jnp.asarray(tgt), sdr_type=sdr_type),
           lambda e: tl.pairwise_neg_sdr(e, torch.from_numpy(tgt), sdr_type=sdr_type),
           est, (3, s, s))


@pytest.mark.parametrize("s", [2, 3])
def test_pit_from_pair_matrix_matches_jax(s):
    pw = np.random.default_rng(s).standard_normal((5, s, s)).astype(np.float32)
    jv, ji = jl.pit_from_pair_matrix(jnp.asarray(pw))
    tv, ti = tl.pit_from_pair_matrix(torch.from_numpy(pw))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **VAL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # rows are targets: a matrix that is not symmetric picks the transpose's best
    _check(lambda p: jl.pit_from_pair_matrix(p)[0],
           lambda p: tl.pit_from_pair_matrix(p)[0], pw, (5,))


def test_pit_from_pair_matrix_transposes_to_target_rows():
    # est 0 fits target 1 and est 1 fits target 0; target 2 <- est 2
    pw = np.full((1, 3, 3), 5.0, np.float32)
    pw[0, 0, 1], pw[0, 1, 0], pw[0, 2, 2] = -1.0, -2.0, -3.0
    pw[0, 1, 2] = -10.0  # est 1 -> target 2 would win only without the transpose
    _, ti = tl.pit_from_pair_matrix(torch.from_numpy(pw))
    _, ji = jl.pit_from_pair_matrix(jnp.asarray(pw))
    assert int(ti[0]) == int(ji[0])
    perm = tl.all_permutations(3)[int(ti[0])]
    assert list(perm) == list(jl.sisdr.all_permutations(3)[int(ji[0])])


@pytest.mark.parametrize("s", [2, 3])
def test_reorder_sources_matches_jax(s):
    est, tgt, _ = _inputs(s)
    idx = np.random.default_rng(4).integers(0, len(tl.all_permutations(s)), size=3)
    got = tl.reorder_sources(torch.from_numpy(est), torch.from_numpy(idx))
    want = jl.reorder_sources(jnp.asarray(est), jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("zero_mean", [True, False])
def test_pit_neg_sdr_loss_matches_jax(s, zero_mean):
    est, tgt, _ = _inputs(s, seed=s)
    _check(lambda e: jl.pit_neg_sdr_loss(e, jnp.asarray(tgt), zero_mean=zero_mean),
           lambda e: tl.pit_neg_sdr_loss(e, torch.from_numpy(tgt), zero_mean=zero_mean),
           est, ())
    jloss, jre = jl.pit_neg_sdr_loss(jnp.asarray(est), jnp.asarray(tgt), return_est=True)
    tloss, tre = tl.pit_neg_sdr_loss(torch.from_numpy(est), torch.from_numpy(tgt),
                                     return_est=True)
    np.testing.assert_allclose(float(tloss), float(jloss), **VAL)
    np.testing.assert_array_equal(tre.numpy(), np.asarray(jre))


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("individual", [True, False])
def test_perm_invariant_sisdr_improvement_matches_jax(s, individual):
    est, tgt, mix = _inputs(s, seed=10 + s)
    kw = dict(n_sources=s, zero_mean=True, backward_loss=False, improvement=True,
              return_individual_results=individual)
    jm, tm = jl.PermInvariantSISDR(**kw), tl.PermInvariantSISDR(**kw)
    _check(lambda e: jm(e, jnp.asarray(tgt), initial_mixtures=jnp.asarray(mix)),
           lambda e: tm(e, torch.from_numpy(tgt), initial_mixtures=torch.from_numpy(mix)),
           est, (3,) if individual else ())
    # the improvement baseline is the mean over the whole batch
    _, jp = jm(jnp.asarray(est), jnp.asarray(tgt), initial_mixtures=jnp.asarray(mix),
               return_best_permutation=True)
    _, tp = tm(torch.from_numpy(est), torch.from_numpy(tgt),
               initial_mixtures=torch.from_numpy(mix), return_best_permutation=True)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_perm_invariant_sisdr_loss_mode_matches_jax():
    est, tgt, _ = _inputs(2, seed=7)
    jm = jl.PermInvariantSISDR(n_sources=2)
    tm = tl.PermInvariantSISDR(n_sources=2)
    _check(lambda e: jm(e, jnp.asarray(tgt)), lambda e: tm(e, torch.from_numpy(tgt)), est, ())


@pytest.mark.parametrize("weights", ["uniform", "magsq"])
def test_mixture_consistency_matches_jax(weights):
    est, _, mix = _inputs(3, seed=21)
    _check(lambda e: jl.mixture_consistency(e, jnp.asarray(mix), weights),
           lambda e: tl.mixture_consistency(e, torch.from_numpy(mix), weights),
           est, est.shape)
    got = tl.mixture_consistency(torch.from_numpy(est), torch.from_numpy(mix), weights)
    # the projected estimates sum to the mixture
    np.testing.assert_allclose(got.sum(1, keepdim=True).numpy(), mix, atol=1e-4)
    with pytest.raises(ValueError, match="weight type"):
        tl.mixture_consistency(torch.from_numpy(est), torch.from_numpy(mix), "nope")
