"""Overlap-add chunked inference for long recordings (counterpart of
``sudo_rm_rf_tpu/inference/overlap_add.py``).

  * the recording is cut into fixed-length 50%-overlapping chunks, run in
    fixed-size batches (the last one padded with zero chunks);
  * each chunk is standardized before the model and de-standardized after,
    optionally with its estimates projected onto its mixture in between
    (mixture consistency);
  * source permutations are re-aligned between consecutive chunks by
    maximizing overlap correlation, on the host;
  * chunks are blended with a periodic Hann window (COLA at 50% hop), the
    first and last chunks keeping full weight at the borders;
  * with a ``parallel.Mesh``, every rank holds the recording and each chunk
    batch is split over the data group: each data index runs its chunks
    through the model's own forward (K1 under ``impl="kernel"``), the
    estimates are all-gathered, and every rank blends the whole recording.
"""

from __future__ import annotations

import itertools
import os
from typing import Callable, Optional

import numpy as np
import torch

from sudo_rm_rf_tpu_torch.losses import mixture_consistency
from sudo_rm_rf_tpu_torch.parallel import shard_batch
from sudo_rm_rf_tpu_torch.parallel.collectives import all_gather_rows
from sudo_rm_rf_tpu_torch.utils import tracing


def _hann(n: int) -> np.ndarray:
    # periodic Hann: COLA (sums to 1) at hop n//2
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


class OverlapAddSeparator:
    """Stream a long mixture through a fixed-shape separator.

    Args:
      model: ``nn.Module`` (B, 1, T) -> (B, S, T); its parameters' device is
        where the chunks run.
      chunk_samples: model input length per chunk (e.g. 4 s * fs).
      batch_chunks: chunks per forward (static batch).
      mixture_consistency: optional 'uniform' / 'magsq' projection of each
        chunk's estimates onto its (standardized) mixture, as the reference
        applies to GroupComm outputs.
      forward_fn: (B, 1, T) -> (B, S, T) in place of ``model`` — e.g.
        ``functools.partial(models.fast_inference.improved_forward_fast, model)``.
      mesh: optional ``parallel.Mesh``; every rank of it calls ``separate``
        with the same recording, and chunk batches are split over its data
        group. batch_chunks is rounded up to a multiple of its data size.
    """

    def __init__(
        self,
        model,
        chunk_samples: int,
        num_sources: int = 2,
        batch_chunks: int = 8,
        mixture_consistency: Optional[str] = None,
        forward_fn: Optional[Callable] = None,
        mesh=None,
    ):
        if mixture_consistency not in (None, "uniform", "magsq"):
            raise ValueError(f"mixture_consistency {mixture_consistency!r} not in "
                             "(None, 'uniform', 'magsq')")
        self.mixture_consistency = mixture_consistency
        self._apply = forward_fn or model
        self.device = next(model.parameters()).device
        self.chunk = int(chunk_samples)
        self.hop = self.chunk // 2
        self.num_sources = num_sources
        self.mesh = mesh
        if mesh is not None:
            batch_chunks = -(-batch_chunks // mesh.n_data) * mesh.n_data
        self.batch_chunks = batch_chunks
        self.window = _hann(self.chunk).astype(np.float32)
        self._perms = list(itertools.permutations(range(num_sources)))

    @torch.no_grad()
    def _forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, chunk)
        mean = x.mean(dim=-1, keepdim=True)
        std = x.std(dim=-1, keepdim=True)  # ddof=1
        xn = (x - mean) / (std + 1e-9)
        est = self._apply(xn[:, None, :])
        if self.mixture_consistency is not None:
            est = mixture_consistency(est, xn[:, None, :], self.mixture_consistency)
        # de-standardize back to the input scale
        return est * std[:, None, :] + mean[:, None, :]

    def _run_chunks(self, frames: np.ndarray) -> np.ndarray:
        """(n_chunks, chunk) -> (n_chunks, S, chunk), batched at a static size."""
        n = frames.shape[0]
        outs = []
        for start in range(0, n, self.batch_chunks):
            batch = frames[start : start + self.batch_chunks]
            valid = batch.shape[0]
            with tracing.span("overlap_add.batch", rows=valid, slots=self.batch_chunks) as sp:
                with tracing.span("overlap_add.upload"):
                    if valid < self.batch_chunks:
                        batch = np.concatenate(
                            [batch, np.zeros((self.batch_chunks - valid, self.chunk),
                                             np.float32)],
                            axis=0,
                        )
                    batch = torch.from_numpy(batch).to(self.device)
                    if self.mesh is not None:
                        local = shard_batch(self.mesh, batch)
                with tracing.span("overlap_add.forward"):
                    if self.mesh is None:
                        est = self._forward(batch)
                    else:
                        est = all_gather_rows(self._forward(local), self.mesh.data_group)
                with tracing.span("overlap_add.fetch"):
                    out = est[:valid].cpu().numpy()
                sp.set(h2d_bytes=batch.nbytes, d2h_bytes=out.nbytes)
            outs.append(out)
        return np.concatenate(outs, axis=0)

    def _align(self, prev_tail: np.ndarray, est: np.ndarray) -> np.ndarray:
        """Pick the source permutation of `est` best correlated with the
        previous chunk's overlapping tail. prev_tail/est-head: (S, hop)."""
        head = est[:, : self.hop]
        best_perm, best_score = None, -np.inf
        for perm in self._perms:
            score = sum(
                float(np.dot(prev_tail[s], head[perm[s]]))
                for s in range(self.num_sources)
            )
            if score > best_score:
                best_score, best_perm = score, perm
        return est[list(best_perm)]

    def separate(self, mixture: np.ndarray) -> np.ndarray:
        """(T,) mixture -> (S, T) separated sources."""
        with tracing.span("overlap_add.separate") as root:
            mixture = np.asarray(mixture, np.float32).reshape(-1)
            t = mixture.shape[0]
            # one chunk at full weight where t <= chunk
            n_chunks = max(1, -(-(t - self.chunk) // self.hop) + 1)
            root.set(samples=t, chunks=n_chunks)
            with tracing.span("overlap_add.chunk"):
                total = (n_chunks - 1) * self.hop + self.chunk
                padded = np.zeros(total, np.float32)
                padded[:t] = mixture
                idx = np.arange(self.chunk)[None, :] + self.hop * np.arange(n_chunks)[:, None]
                frames = padded[idx]
            est = self._run_chunks(frames)  # (n_chunks, S, chunk)

            with tracing.span("overlap_add.stitch"):
                out = np.zeros((self.num_sources, total), np.float32)
                norm = np.zeros(total, np.float32)
                prev = None
                for c in range(n_chunks):
                    cur = est[c]
                    if prev is not None:
                        with tracing.span("overlap_add.align"):
                            cur = self._align(prev[:, -self.hop :], cur)
                    start = c * self.hop
                    w = self.window.copy()
                    if c == 0:
                        w[: self.hop] = 1.0
                    if c == n_chunks - 1:
                        w[self.hop :] = 1.0
                    out[:, start : start + self.chunk] += cur * w
                    norm[start : start + self.chunk] += w
                    prev = cur
                out /= np.maximum(norm, 1e-8)
                return out[:, :t]


def separate_file(
    model,
    in_path: str,
    out_dir: str,
    fs: int = 8000,
    chunk_seconds: float = 4.0,
    num_sources: int = 2,
    separator=None,
    write: bool = True,
    **kwargs,
):
    """Read a wav, separate it, write <stem>_s{i}.wav files (int16, peak-
    normalized where the peak exceeds 1). ``separator``: anything with
    ``separate((T,)) -> (S, T)`` (default: an ``OverlapAddSeparator`` of
    ``model`` built from the other arguments). ``write=False`` separates and
    writes nothing (a rank other than the writer of a launch); returns []."""
    from scipy.io import wavfile

    from sudo_rm_rf_tpu_torch.data.base import read_wav

    sr, wav = read_wav(in_path)
    if sr != fs:
        raise ValueError(f"{in_path}: sample rate {sr} != expected {fs}")
    if separator is None:
        separator = OverlapAddSeparator(
            model, chunk_samples=int(chunk_seconds * fs), num_sources=num_sources,
            **kwargs,
        )
    est = separator.separate(wav)
    if not write:
        return []
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(in_path))[0]
    paths = []
    for s in range(est.shape[0]):
        out = est[s]
        peak = np.abs(out).max()
        if peak > 1.0:
            out = out / peak
        path = os.path.join(out_dir, f"{stem}_s{s + 1}.wav")
        wavfile.write(path, fs, (out * 32767).astype(np.int16))
        paths.append(path)
    return paths
