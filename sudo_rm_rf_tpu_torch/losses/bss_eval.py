"""BSS-eval source-separation metrics (SDR / SIR / SAR) in closed form
(counterpart of ``sudo_rm_rf_tpu/losses/bss_eval.py``).

Each estimate e is split into

    s_target = P_j e                    (projection onto target j)
    e_interf = P_S e - s_target         (other-source leakage)
    e_artif  = e - P_S e                (everything else)

with ``P_j`` the orthogonal projection onto the span of target j's
``filter_taps`` delayed copies and ``P_S`` onto all sources' delayed copies
(Vincent et al. 2006). ``filter_taps=1`` is the scalar-gain case; 512 is the
museval / mir_eval default. Both are orthogonal projections, so every norm
is a correlation solve and no filtered signal is materialized:

    ||s_target||^2 = d_j^T R_jj^{-1} d_j
    ||e_interf||^2 = e^T P_S e - ||s_target||^2
    ||e_artif||^2  = ||e||^2 - e^T P_S e

with e^T P_S e = D^T G^{-1} D, G the (n L x n L) block-Toeplitz Gram of all
delayed sources; the correlations come from zero-padded FFTs. The
permutation is the best mean SIR over all n! permutations, scored by a
one-hot einsum in the JAX package's layout.

Departure from the JAX package: JAX scores permutation p as estimate e ->
target p[e] and then reports target j against estimate p[j], which is the
scored assignment only where p is its own inverse (always for two sources;
for three or more, a cyclic order of near-perfect estimates reads ~-30 dB).
The port reports target j against the estimate the scored permutation gave
it, p^-1[j]. For two sources the two agree.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A batched solve that, as JAX's, returns inf/NaN for a singular system
    (a silent target) instead of raising, and so never waits on the device
    for the error check."""
    return torch.linalg.solve_ex(a, b)[0]


def _filtered_energies(est: torch.Tensor, targets: torch.Tensor, taps: int, eps: float):
    """Projection energies for ``taps``-long distortion filters (sources
    zero-padded, projections on length T + L - 1).

    Returns (num (B, n_est, n): ||P_j e_i||^2, proj_energy (B, n_est):
    ||P_S e_i||^2, e_powers (B, n_est): ||e_i||^2).
    """
    b, n, t = targets.shape
    L = taps
    n_fft = 1 << (t + L - 1).bit_length()
    sf = torch.fft.rfft(targets, n=n_fft, dim=-1)  # (B, n, F)
    ef = torch.fft.rfft(est, n=n_fft, dim=-1)  # (B, n_est, F)
    # c_kl[m] = sum_t s_k[t] s_l[t - m]; d_ik[m] = sum_t e_i[t] s_k[t - m]
    c_ss = torch.fft.irfft(sf[:, :, None] * sf[:, None, :].conj(), n=n_fft, dim=-1)
    c_es = torch.fft.irfft(ef[:, :, None] * sf[:, None, :].conj(), n=n_fft, dim=-1)

    # Toeplitz block (k, l)[a, b] = sum_t s_k[t - a] s_l[t - b] = c_kl[b - a]
    ar = torch.arange(L, device=targets.device)
    lag = (ar[None, :] - ar[:, None]) % n_fft  # (L, L)
    blocks = c_ss[..., lag]  # (B, n, n, L, L)
    gram = blocks.permute(0, 1, 3, 2, 4).reshape(b, n * L, n * L)
    d = c_es[..., :L]  # (B, n_est, n, L): lags 0..L-1
    d_full = d.reshape(b, n, n * L)  # n_est == n

    # the jitter is (B,): broadcast it over each solve's own batch shape
    jitter = eps * (1.0 + torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1))
    eye = torch.eye(n * L, dtype=gram.dtype, device=gram.device)
    gram_r = gram + jitter[:, None, None] * eye
    # ||P_S e||^2 = d^T G^{-1} d, one right-hand side per estimate
    coefs = _solve(gram_r[:, None], d_full[..., None])[..., 0]
    proj_energy = (coefs * d_full).sum(dim=-1)  # (B, n_est)

    # ||P_j e||^2 = d_j^T R_jj^{-1} d_j per (estimate, target)
    idx = torch.arange(n, device=targets.device)
    diag = blocks[:, idx, idx]  # (B, n, L, L)
    diag_r = diag + jitter[:, None, None, None] * eye[:L, :L]
    cj = _solve(diag_r[:, None], d[..., None])[..., 0]  # (B, n_est, n, L)
    num = (cj * d).sum(dim=-1)

    e_powers = torch.einsum("bet,bet->be", est, est)
    return num, proj_energy, e_powers


def _db(x: torch.Tensor, y: torch.Tensor, eps: float) -> torch.Tensor:
    # every energy here is >= 0 in exact arithmetic, but roundoff can push
    # one slightly negative when a component is ~absent; clamp both sides
    return 10.0 * torch.log10((x.clamp(min=0.0) + eps) / (y.clamp(min=0.0) + eps))


def bss_eval_sources(
    est: torch.Tensor,
    targets: torch.Tensor,
    eps: float = 1e-10,
    filter_taps: int = 1,
):
    """BSS-eval SDR/SIR/SAR with the permutation of best mean SIR.

    Args:
      est: (B, n, T) estimated sources.
      targets: (B, n, T) true sources (linearly independent).
      filter_taps: distortion-filter length L: 1 = scalar gain (closed
        form); 512 = the museval / mir_eval default.
    Returns:
      dict of 'sdr', 'sir', 'sar', each (B, n), and 'perm' (B, n):
      perm[b, j] is the estimate index assigned to true source j.
    """
    est = est.float()
    targets = targets.float()
    n = targets.shape[1]

    if filter_taps > 1:
        num, proj_energy, e_powers = _filtered_energies(est, targets, filter_taps, eps)
    else:
        gram = torch.einsum("bnt,bmt->bnm", targets, targets)  # (B, n, n)
        cross = torch.einsum("bet,bnt->ben", est, targets)  # <e_i, s_j>
        coefs = _solve(gram[:, None], cross[..., None])[..., 0]
        proj_energy = (coefs * cross).sum(dim=-1)  # (B, n_est)
        t_powers = torch.einsum("bnt,bnt->bn", targets, targets)
        e_powers = torch.einsum("bet,bet->be", est, est)
        num = cross**2 / (t_powers[:, None, :] + eps)  # ||s_target||^2

    sdr_pair = _db(num, e_powers[:, :, None] - num, eps)
    sir_pair = _db(num, proj_energy[:, :, None] - num, eps)
    sar_each = _db(proj_energy, e_powers - proj_energy, eps)  # (B, n_est)

    perms = np.array(list(itertools.permutations(range(n))))
    onehot = torch.from_numpy(np.stack([np.eye(n)[p] for p in perms]).astype(np.float32))
    sir_scores = torch.einsum("bej,pej->bp", sir_pair, onehot.to(sir_pair.device)) / n
    # the best permutation sends estimate e to target best[e]; target j's
    # estimate is its inverse, assign[j]
    best = torch.from_numpy(perms).to(est.device)[sir_scores.argmax(dim=-1)]  # (B, n)
    assign = torch.argsort(best, dim=-1)

    pick = lambda pair: torch.gather(pair, 1, assign[:, None, :])[:, 0]
    sar = torch.gather(sar_each, 1, assign)
    return {"sdr": pick(sdr_pair), "sir": pick(sir_pair), "sar": sar, "perm": assign}


def bss_eval_improvement(
    est: torch.Tensor,
    targets: torch.Tensor,
    mixture: torch.Tensor,
    eps: float = 1e-10,
    filter_taps: int = 1,
):
    """BSS-eval of ``est`` with 'sdr_i': its SDR minus that of the mixture
    repeated per source (asteroid's ``input_sdr`` convention)."""
    res = bss_eval_sources(est, targets, eps, filter_taps=filter_taps)
    mix = (mixture if mixture.ndim == 3 else mixture[:, None, :]).expand(targets.shape)
    base = bss_eval_sources(mix, targets, eps, filter_taps=filter_taps)
    return {"sdr_i": res["sdr"] - base["sdr"], **res}
