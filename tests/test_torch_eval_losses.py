"""The port's evaluation losses and metrics against the JAX package, on the
CPU: the stabilized variable-source-count SI-SDR, the zero-reference SNR
(the FUSS training loss, values and gradients), the permutation-invariant
L1, the functional SDR losses and BSS-eval with its improvement.

Tolerances: metric values rtol = atol = 1e-5 (dB), gradients rtol = atol =
1e-4 of the largest |grad|; BSS-eval in fp32 within 2e-3 dB at
filter_taps 1 and 5e-3 dB at 512 (XLA's CPU solve and LAPACK's round apart
on the 1024 x 1024 block-Toeplitz Gram), with the same permutation; its
energies in float64 on both sides within 1e-12 relative (the formula
itself agrees).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sudo_rm_rf_tpu import losses as jl
from sudo_rm_rf_tpu.losses import bss_eval as jbss
from sudo_rm_rf_tpu_torch import losses as tl
from sudo_rm_rf_tpu_torch.losses import bss_eval as tbss
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

VAL = dict(rtol=1e-5, atol=1e-5)


def _signals(b, s, t, seed):
    x = np.cumsum(np.random.default_rng(seed).standard_normal((b, s, t)), axis=-1)
    return (x / x.std(axis=-1, keepdims=True)).astype(np.float32)


def _est_for(targets, n_est, seed):
    """Estimates that hold the targets in a shuffled order, plus noise."""
    b, s, t = targets.shape
    rng = np.random.default_rng(seed)
    est = 0.3 * rng.standard_normal((b, n_est, t)).astype(np.float32)
    for i in range(b):
        slots = rng.permutation(n_est)[:s]
        est[i, slots] += targets[i]
    return est


# -- stabilized SI-SDR --------------------------------------------------------


# improvement with one source is left out: its baseline mixture IS the
# target, so rho^2 rounds to within an ulp of 1 and the value sits on the
# eps ceiling, where one ulp moves it by dB (FUSS never asks for it)
@pytest.mark.parametrize("n_est,n_act,improvement", [
    (n, a, imp) for n in (1, 2, 4) for a in range(1, 5) for imp in (False, True)
    if a <= n and not (imp and a == 1)])
def test_stabilized_metric_matches_jax(n_est, n_act, improvement):
    tgt = _signals(3, n_act, 400, seed=n_est * 10 + n_act)
    est = _est_for(tgt, n_est, seed=7)
    kw = dict(n_estimated_sources=n_est, n_actual_sources=n_act, zero_mean=True,
              improvement=improvement, backward_loss=False, return_individual_results=True)
    want, wperm = jl.StabilizedPermInvSISDRMetric(**kw)(
        jnp.asarray(est), jnp.asarray(tgt), return_best_permutation=True)
    got, perm = tl.StabilizedPermInvSISDRMetric(**kw)(
        torch.from_numpy(est), torch.from_numpy(tgt), return_best_permutation=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))


@pytest.mark.parametrize("n_est", [1, 2, 4])
def test_stabilized_metric_single_source_matches_jax(n_est):
    """single_source sums the estimates first: the trivial permutation."""
    tgt = _signals(2, 1, 300, seed=3)
    est = _est_for(tgt, n_est, seed=4)
    kw = dict(n_estimated_sources=n_est, n_actual_sources=1, single_source=True)
    want = jl.StabilizedPermInvSISDRMetric(**kw)(jnp.asarray(est), jnp.asarray(tgt))
    metric = tl.StabilizedPermInvSISDRMetric(**kw)
    got = metric(torch.from_numpy(est), torch.from_numpy(tgt))
    np.testing.assert_allclose(float(got), float(want), **VAL)
    assert metric.permutations.tolist() == [[0]]


def test_stabilized_metric_clips_rho_when_the_mixture_is_a_target():
    """An example whose other sources are silent makes the improvement
    baseline's mixture equal its target; the clip keeps every value finite,
    in both packages (the values sit on the eps ceiling, see above)."""
    tgt = _signals(3, 3, 800, seed=5)
    tgt[0, 1:] = 0.0
    est = _est_for(tgt, 4, seed=6)
    kw = dict(n_estimated_sources=4, n_actual_sources=3, zero_mean=True, improvement=True,
              backward_loss=False, return_individual_results=True)
    got = tl.StabilizedPermInvSISDRMetric(**kw)(torch.from_numpy(est), torch.from_numpy(tgt))
    want = jl.StabilizedPermInvSISDRMetric(**kw)(jnp.asarray(est), jnp.asarray(tgt))
    assert torch.isfinite(got).all() and np.isfinite(np.asarray(want)).all()


def test_partial_permutations_match_jax():
    from sudo_rm_rf_tpu.losses.sisdr import partial_permutations

    for n, r in itertools.product(range(1, 5), range(1, 5)):
        if r <= n:
            np.testing.assert_array_equal(tl.partial_permutations(n, r),
                                          partial_permutations(n, r))


# -- zero-reference SNR (the FUSS loss) ---------------------------------------


def _fuss_batch(seed, b=4, s=4, t=500):
    tgt = _signals(b, s, t, seed)
    tgt[0, 2:] = 0.0  # zero-padded rows: silent targets
    tgt[1, 3] *= 1e-4  # -80 dB: inactive by the -40 dB threshold
    est = _est_for(tgt, s, seed + 1)
    return est, tgt


@pytest.mark.parametrize("zero_mean", [False, True])
@pytest.mark.parametrize("individual", [False, True])
def test_zero_ref_snr_matches_jax_values_and_grads(zero_mean, individual):
    est, tgt = _fuss_batch(11)
    kw = dict(n_sources=4, zero_mean=zero_mean, return_individual_results=individual)
    w = np.random.default_rng(2).standard_normal(4 if individual else ()).astype(np.float32)

    jfn = jl.PermInvariantSNRwithZeroRefs(**kw)
    want, wgrad = jax.value_and_grad(
        lambda e: jnp.sum(jfn(e, jnp.asarray(tgt)) * w))(jnp.asarray(est))
    e = torch.from_numpy(est).requires_grad_()
    got = (tl.PermInvariantSNRwithZeroRefs(**kw)(e, torch.from_numpy(tgt))
           * torch.from_numpy(w)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **VAL)
    g = np.asarray(wgrad)
    np.testing.assert_allclose(e.grad.numpy(), g, rtol=1e-4, atol=1e-4 * np.abs(g).max())
    # the estimates assigned to example 0's two silent targets get no gradient
    assert int((e.grad[0].abs().sum(-1) == 0).sum()) == 2
    assert tl.SimplerPermInvariantSNRwithZeroRefs is tl.PermInvariantSNRwithZeroRefs


def test_zero_ref_snr_best_permutation_matches_jax():
    est, tgt = _fuss_batch(12)
    kw = dict(n_sources=4, return_individual_results=True, backward_loss=False)
    _, wperm = jl.PermInvariantSNRwithZeroRefs(**kw)(
        jnp.asarray(est), jnp.asarray(tgt), return_best_permutation=True)
    _, perm = tl.PermInvariantSNRwithZeroRefs(**kw)(
        torch.from_numpy(est), torch.from_numpy(tgt), return_best_permutation=True)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))


# -- perm_invariant_norm and the functional losses ----------------------------


@pytest.mark.parametrize("weighted_norm", [0.0, 2.0])
@pytest.mark.parametrize("s", [2, 3])
def test_perm_invariant_norm_matches_jax(weighted_norm, s):
    from sudo_rm_rf_tpu.losses.norm import perm_invariant_norm

    tgt = _signals(3, s, 200, seed=20)
    est = _est_for(tgt, s, seed=21)
    want = perm_invariant_norm(jnp.asarray(est), jnp.asarray(tgt), weighted_norm=weighted_norm)
    got = tl.perm_invariant_norm(torch.from_numpy(est), torch.from_numpy(tgt),
                                 weighted_norm=weighted_norm)
    np.testing.assert_allclose(float(got), float(want), **VAL)


@pytest.mark.parametrize("si", [False, True])
def test_functional_losses_match_jax(si):
    from sudo_rm_rf_tpu.losses import functional as jf

    from sudo_rm_rf_tpu_torch.losses import functional as tf

    tgt = _signals(3, 2, 300, seed=30)
    est = _est_for(tgt, 2, seed=31)
    jt, je, tt, te = jnp.asarray(tgt), jnp.asarray(est), torch.from_numpy(tgt), torch.from_numpy(est)
    np.testing.assert_allclose(tf.sdr(tt, te, si=si).numpy(), np.asarray(jf.sdr(jt, je, si=si)),
                               **VAL)
    loss = tf.sisdr_loss if si else tf.sdri_loss
    jloss = jf.sisdr_loss if si else jf.sdri_loss
    np.testing.assert_allclose(float(loss(tt, te, 0.5)), float(jloss(jt, je, 0.5)), **VAL)
    np.testing.assert_allclose(float(tf.pit_loss(tt, te, si=si)),
                               float(jf.pit_loss(jt, je, si=si)), **VAL)
    # rank-2 inputs are lifted to a batch of one
    np.testing.assert_allclose(float(tf.sdri_loss(tt[0], te[0])), float(jf.sdri_loss(jt[0], je[0])),
                               **VAL)


# -- BSS-eval -----------------------------------------------------------------


def _bss_case(b=3, n=2, t=2000, seed=40):
    rng = np.random.default_rng(seed)
    tgt = rng.standard_normal((b, n, t)).astype(np.float32)
    mix_mat = rng.standard_normal((b, n, n)).astype(np.float32) + 2.0 * np.eye(n, dtype=np.float32)
    est = np.einsum("ben,bnt->bet", mix_mat, tgt)
    est[:, 0, 3:] += 0.4 * tgt[:, 1, :-3]  # filtered leakage
    est += 0.2 * rng.standard_normal(est.shape).astype(np.float32)
    return np.ascontiguousarray(est[:, ::-1]), tgt


@pytest.mark.parametrize("taps,tol_db", [(1, 2e-3), (512, 5e-3)])
def test_bss_eval_improvement_matches_jax(taps, tol_db):
    est, tgt = _bss_case()
    mix = tgt.sum(1, keepdims=True)
    want = jbss.bss_eval_improvement(jnp.asarray(est), jnp.asarray(tgt), jnp.asarray(mix),
                                     filter_taps=taps)
    got = tbss.bss_eval_improvement(torch.from_numpy(est), torch.from_numpy(tgt),
                                    torch.from_numpy(mix), filter_taps=taps)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["perm"].numpy(), np.asarray(want["perm"]))
    for k in ("sdr", "sir", "sar", "sdr_i"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=tol_db,
                                   err_msg=k)
    # a (B, T) mixture is taken as (B, 1, T)
    flat = tbss.bss_eval_improvement(torch.from_numpy(est), torch.from_numpy(tgt),
                                     torch.from_numpy(mix[:, 0]), filter_taps=taps)
    assert torch.equal(flat["sdr_i"], got["sdr_i"])


@pytest.mark.parametrize("taps", [1, 512])
def test_bss_eval_energies_agree_in_float64(taps):
    est, tgt = _bss_case(seed=41)
    with jax.enable_x64(True):
        want = jbss._filtered_energies(jnp.asarray(est, jnp.float64),
                                       jnp.asarray(tgt, jnp.float64), taps, 1e-10)
        want = [np.asarray(w) for w in want]
    got = tbss._filtered_energies(torch.from_numpy(est).double(),
                                  torch.from_numpy(tgt).double(), taps, 1e-10)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12 * np.abs(w).max())


def test_bss_eval_finite_on_perfect_separation():
    tgt = _signals(2, 2, 800, seed=42)
    got = tbss.bss_eval_sources(torch.from_numpy(tgt[:, ::-1].copy()), torch.from_numpy(tgt))
    assert all(torch.isfinite(got[k]).all() for k in ("sdr", "sir", "sar"))
    assert (got["sir"] > 40).all() and got["perm"].tolist() == [[1, 0], [1, 0]]


def _bss_oracle(est, tgt):
    """Per-target brute force of BSS-eval at one tap, in float64 numpy: for
    every assignment of targets to estimates (target j -> estimate q[j]),
    each pair's SDR, SIR and SAR from its explicit projections; the
    assignment of best mean SIR wins. Returns ((n,) sdr, sir, sar, q)."""
    est, tgt = est.astype(np.float64), tgt.astype(np.float64)
    n = tgt.shape[0]
    coef = np.linalg.lstsq(tgt.T, est.T, rcond=None)[0]  # P_S e = coef^T S
    p_s = (tgt.T @ coef).T  # (n_est, T)

    def metrics(e, j):
        s_t = (est[e] @ tgt[j]) / (tgt[j] @ tgt[j]) * tgt[j]
        e_interf, e_artif = p_s[e] - s_t, est[e] - p_s[e]
        db = lambda a, b: 10 * np.log10((a @ a) / (b @ b))
        return db(s_t, e_interf + e_artif), db(s_t, e_interf), db(s_t + e_interf, e_artif)

    best = max(itertools.permutations(range(n)),
               key=lambda q: np.mean([metrics(q[j], j)[1] for j in range(n)]))
    rows = np.array([metrics(best[j], j) for j in range(n)])
    return rows[:, 0], rows[:, 1], rows[:, 2], list(best)


def test_bss_eval_three_sources_matches_jax_and_its_cyclic_assignment():
    """With three or more sources the JAX package scores permutation p as
    estimate e -> target p[e] but reports target j against estimate p[j]
    (for a cyclic order of good estimates, far below 0 dB). The port
    reports the scored assignment: it matches a per-target brute-force
    oracle (within 2e-3 dB, fp32 against float64), where the JAX package
    does not; with two sources it matches JAX
    (``test_bss_eval_improvement_matches_jax``)."""
    rng = np.random.default_rng(1)
    tgt = rng.standard_normal((2, 3, 1000)).astype(np.float32)
    # each estimate: one target, leakage of another (SIR ~20 dB, where fp32
    # still resolves the interference energy) and noise
    est = np.stack([tgt[0, [1, 2, 0]] + 0.1 * tgt[0, [2, 0, 1]],
                    tgt[1, [2, 0, 1]] + 0.1 * tgt[1, [0, 1, 2]]])
    est = est + 0.1 * rng.standard_normal(est.shape).astype(np.float32)
    got = tbss.bss_eval_sources(torch.from_numpy(est), torch.from_numpy(tgt))
    want = jbss.bss_eval_sources(jnp.asarray(est), jnp.asarray(tgt))
    for i in range(2):
        sdr, sir, sar, perm = _bss_oracle(est[i], tgt[i])
        assert got["perm"][i].tolist() == perm
        for k, w in (("sdr", sdr), ("sir", sir), ("sar", sar)):
            np.testing.assert_allclose(got[k][i].numpy(), w, rtol=0, atol=2e-3, err_msg=k)
        assert (got["sdr"][i] > 10).all()
        # JAX reports each target against another target's estimate
        assert np.asarray(want["perm"][i]).tolist() != perm
        assert (np.asarray(want["sdr"][i]) < -10).all()
    # target j holds estimate (j - 1) % 3, then (j + 1) % 3
    assert got["perm"].tolist() == [[2, 0, 1], [1, 2, 0]]
