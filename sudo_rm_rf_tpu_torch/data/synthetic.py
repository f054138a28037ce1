"""A small WHAM-layout corpus of synthetic voiced speakers, made from a seed.

Each "speaker" is a source-filter voice: a pitch-contoured impulse train
with syllabic voicing gates through a speaker-specific formant cascade
(``synth_utterance`` is the port's copy of the one in
``scripts/make_synthetic_corpus.py``). Two different speakers are separable
by spectro-temporal structure, so a model trained on such mixtures learns.
Imports numpy and scipy only.
"""

from __future__ import annotations

import os

import numpy as np


def _resonator(f_hz: float, bw_hz: float, fs: int):
    """2nd-order all-pole resonator coefficients (formant filter)."""
    r = np.exp(-np.pi * bw_hz / fs)
    theta = 2 * np.pi * f_hz / fs
    return [1.0], [1.0, -2 * r * np.cos(theta), r * r]


def make_speaker(rng: np.random.Generator) -> dict:
    """Sample speaker-level parameters."""
    return {
        "f0": float(rng.uniform(85, 280)),
        "formants": [
            (float(rng.uniform(280, 900)), float(rng.uniform(60, 120))),
            (float(rng.uniform(900, 2300)), float(rng.uniform(80, 160))),
            (float(rng.uniform(2300, 3300)), float(rng.uniform(100, 200))),
        ],
        "breathiness": float(rng.uniform(0.02, 0.12)),
        "syllable_rate": float(rng.uniform(2.5, 5.5)),
    }


def synth_utterance(spk: dict, rng: np.random.Generator, fs: int, n: int) -> np.ndarray:
    """One peak-normalized utterance of ``n`` samples."""
    from scipy.signal import lfilter

    t = np.arange(n) / fs
    # pitch contour: slow random walk + vibrato around the speaker F0
    drift = np.cumsum(rng.standard_normal(n)) / fs
    drift = drift / (np.abs(drift).max() + 1e-9) * spk["f0"] * 0.15
    f0 = spk["f0"] + drift + 3.0 * np.sin(2 * np.pi * 5.5 * t)
    # glottal impulse train via phase accumulation
    phase = np.cumsum(f0) / fs
    excitation = np.zeros(n, np.float32)
    excitation[np.diff(np.floor(phase), prepend=0.0) > 0] = 1.0
    excitation += spk["breathiness"] * rng.standard_normal(n).astype(np.float32)
    # syllabic voicing gate: smoothed random on/off at the syllable rate
    n_syl = max(int(spk["syllable_rate"] * n / fs), 1)
    gates = (rng.random(n_syl + 1) > 0.25).astype(np.float32) * rng.uniform(
        0.4, 1.0, n_syl + 1
    )
    env = np.interp(np.arange(n), np.linspace(0, n - 1, n_syl + 1), gates)
    win = max(1, min(int(0.02 * fs), n))
    env = np.convolve(env, np.ones(win) / win, mode="same").astype(np.float32)
    x = excitation * env
    for f_hz, bw in spk["formants"]:
        b, a = _resonator(f_hz, bw, fs)
        x = lfilter(b, a, x).astype(np.float32)
    x = np.diff(x, prepend=0.0).astype(np.float32)  # lip radiation
    peak = np.abs(x).max() + 1e-9
    return (x / peak).astype(np.float32)


def write_wham_corpus(root: str, n_train: int = 16, n_val: int = 8,
                      seconds: float = 4.0, fs: int = 8000, seed: int = 0) -> str:
    """Write ``root/wav{fs/1000}k/min/{tr,cv}/{mix_clean,s1,s2}/*.wav``
    (int16): per file two utterances of two different speakers at 0.5 peak
    and their sum. Returns ``root``."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    for split, count in (("tr", n_train), ("cv", n_val)):
        base = os.path.join(root, f"wav{fs // 1000}k", "min", split)
        for d in ("mix_clean", "s1", "s2"):
            os.makedirs(os.path.join(base, d), exist_ok=True)
        for i in range(count):
            s1 = 0.5 * synth_utterance(make_speaker(rng), rng, fs, n)
            s2 = 0.5 * synth_utterance(make_speaker(rng), rng, fs, n)
            for d, wav in (("s1", s1), ("s2", s2), ("mix_clean", s1 + s2)):
                wavfile.write(os.path.join(base, d, f"utt{i:04d}.wav"), fs,
                              np.round(wav * 32767).astype(np.int16))
    return root
