"""Overlap-add separation of one recording, in NumPy around a chunk forward.

The semantics ``sudo-torch-separate`` serves: the recording is cut into
chunks of ``chunk`` samples at a hop of half a chunk (zero padded at the
end; a recording no longer than a chunk is one padded chunk); each chunk is
standardized (mean, ddof=1 std + 1e-9), separated and de-standardized; from
the second chunk on, the source order is the permutation whose overlap
with the previous (aligned) chunk's tail correlates best; chunks are
blended with a periodic Hann window, the first chunk's head and the last
chunk's tail at full weight, and the sum divided by the summed weights.
"""

from __future__ import annotations

import itertools

import numpy as np


# A permutation choice whose two best scores lie within this share of
# their size is a tie that the program's fp32 rounding may decide either
# way, and either branch is a right answer. The program's sources lie
# within 1e-6 of this float64 reference's (PERF.md section 4), which moves
# a margin by about 2e-6 at most; 1e-5 leaves room above that.
TIE = 1e-5


def separate(mixture: np.ndarray, chunk: int, n_sources: int, forward, batch: int = 8,
             follow: np.ndarray = None, choices: list = None):
    """(T,) -> (S, T). ``forward`` maps standardized chunks (n, chunk) to
    their estimates (n, S, chunk), float64 or float32.

    ``follow``, the answer being judged: at a tie the branch whose blend
    over the chunk's first half lies nearer to it is taken (the program's
    own choice; every choice that is not a tie is the reference's).
    ``choices``, if a list, gets each choice's (margin, whether the answer
    took the reference's best branch there), the second only with
    ``follow``."""
    x = np.asarray(mixture, np.float64).reshape(-1)
    t, hop = x.shape[0], chunk // 2
    n = 1 if t <= chunk else -(-(t - chunk) // hop) + 1
    total = chunk if n == 1 else (n - 1) * hop + chunk
    padded = np.zeros(total)
    padded[:t] = x
    frames = np.stack([padded[c * hop: c * hop + chunk] for c in range(n)])
    mean = frames.mean(axis=-1, keepdims=True)
    std = frames.std(axis=-1, ddof=1, keepdims=True)
    normed = (frames - mean) / (std + 1e-9)
    est = np.concatenate([np.asarray(forward(normed[i:i + batch]), np.float64)
                          for i in range(0, n, batch)])
    est = est * std[:, :, None] + mean[:, :, None]
    if n == 1:
        return est[0][:, :t]
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(chunk) / chunk)
    perms = [list(p) for p in itertools.permutations(range(n_sources))]
    aligned = [est[0]]
    for c in range(1, n):
        tail, head = aligned[-1][:, -hop:], est[c][:, :hop]
        scores = [sum(float(tail[s] @ head[p[s]]) for s in range(n_sources)) for p in perms]
        order = sorted(range(len(perms)), key=lambda i: -scores[i])  # stable: first best
        pick = order[0]
        a, b = scores[order[0]], scores[order[1]]
        margin = (a - b) / max(abs(a) + abs(b), 1e-300)
        taken = None
        if follow is not None:
            # the overlap's blend under each branch, against the answer there
            seg = follow[:, c * hop:min(c * hop + hop, t)]

            def miss(i):  # the Hann weights of an overlap sum to one
                blend = tail * window[hop:] + head[perms[i]] * window[:hop]
                return float(np.square(blend[:, :seg.shape[1]] - seg).sum())

            taken = min(order[:2], key=miss)
            if margin <= TIE:
                pick = taken
        if choices is not None:
            choices.append((margin, None if taken is None else taken == order[0]))
        aligned.append(est[c][perms[pick]])
    out = np.zeros((n_sources, total))
    norm = np.zeros(total)
    for c, cur in enumerate(aligned):
        w = window.copy()
        if c == 0:
            w[:hop] = 1.0
        if c == n - 1:
            w[hop:] = 1.0
        out[:, c * hop: c * hop + chunk] += cur * w
        norm[c * hop: c * hop + chunk] += w
    return (out / np.maximum(norm, 1e-8))[:, :t]
