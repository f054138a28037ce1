"""Small WHAM-, WHAMR!-, FUSS- and hierarchical-layout corpora of synthetic
sounds, made from a seed, for running the recipes where the real corpora
are absent.

Each "speaker" is a source-filter voice: a pitch-contoured impulse train
with syllabic voicing gates through a speaker-specific formant cascade
(``synth_utterance`` is the port's copy of the one in
``scripts/make_synthetic_corpus.py``). Two different speakers are separable
by spectro-temporal structure, so a model trained on such mixtures learns.
The hierarchical corpus (one folder a speaker, one an utterance) is that
script's own. The WHAMR! corpus convolves each voice with a synthetic room
response and adds band-limited noise (the port's copy of
``scripts/make_synthetic_whamr.py``); the FUSS corpus mixes 1-4 sounds of
five distinct families (``scripts/make_synthetic_fuss.py``). Imports numpy
and scipy only.
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


def write_hierarchical_corpus(out: str, train_speakers: int = 40, val_speakers: int = 10,
                              test_speakers: int = 10, utts: int = 60, val_utts: int = 20,
                              fs: int = 8000, seconds: float = 4.0, seed: int = 0) -> str:
    """Write a hierarchical speaker corpus, ``out/{train,val,test}/spk<s>/utt<u>/wav``
    (one energy-normalized (1, T) float32 utterance a folder, written as
    ``joblib.dump`` writes it), the layout that
    ``data.hierarchical.AugmentedOnlineMixingDataset`` reads. The port's copy
    of ``scripts/make_synthetic_corpus.py``: the same files, bit for bit, at
    the same arguments. Split k is drawn from ``seed + k``; val and test take
    ``val_utts`` utterances a speaker. Returns ``out``."""
    from sudo_rm_rf_tpu_torch.prep.hierarchical import _dump_sample

    n = int(fs * seconds)
    for k, (split, n_speakers, n_utts) in enumerate(
            (("train", train_speakers, utts), ("val", val_speakers, val_utts),
             ("test", test_speakers, val_utts))):
        rng = np.random.default_rng(seed + k)
        for s in range(n_speakers):
            spk = make_speaker(rng)
            for u in range(n_utts):
                _dump_sample(os.path.join(out, split, f"spk{s:03d}", f"utt{u:03d}"),
                             synth_utterance(spk, rng, fs, n))
    return out


WHAMR_DIRS = ("s1_reverb", "s2_reverb", "s1_anechoic", "s2_anechoic", "noise",
              "mix_both_reverb", "mix_both_anechoic")


def synth_rir(rng: np.random.Generator, rt60_s: float, fs: int, n_taps: int = 2048) -> np.ndarray:
    """Direct path + sparse early reflections + diffuse exponential tail."""
    rir = np.zeros(n_taps, np.float32)
    rir[0] = 1.0
    for _ in range(rng.integers(3, 8)):  # early reflections < 20 ms
        rir[rng.integers(8, int(0.02 * fs))] += rng.uniform(-0.5, 0.5)
    t = np.arange(n_taps) / fs
    tail = rng.standard_normal(n_taps).astype(np.float32) * np.exp(-6.91 * t / rt60_s)
    tail[: int(0.004 * fs)] = 0.0
    rir += 0.4 * tail
    return rir / (np.abs(rir).max() + 1e-9)


def _pink_noise(rng: np.random.Generator, n: int) -> np.ndarray:
    from scipy.signal import lfilter

    x = rng.standard_normal(n).astype(np.float32)
    lp = lfilter([1.0], [1.0, -0.95], x).astype(np.float32)
    return 0.3 * x + lp / (np.abs(lp).max() + 1e-9)


def _write_peak(path: str, fs: int, x: np.ndarray) -> None:
    """int16 at 0.9 of full scale."""
    from scipy.io import wavfile

    peak = np.abs(x).max() + 1e-9
    wavfile.write(path, fs, (x / peak * 0.9 * 32767).astype(np.int16))


def write_whamr_corpus(root: str, n_train: int = 16, n_val: int = 8, n_test: int = 8,
                       seconds=4.0, fs: int = 8000, seed: int = 0) -> str:
    """Write ``root/wav{fs/1000}k/min/{tr,cv,tt}/<dir>/*.wav`` for every
    directory the WHAMR! tasks read: per file two speakers, each dry
    (anechoic) and through its own room (RT60 0.1-0.5 s, reverberant), noise
    at 5-20 dB below the reverberant speech, and both mixtures. ``seconds``
    is one length, or a sequence of lengths taken by the files in turn.
    Split k is drawn from ``seed + k``. Returns ``root``."""
    from scipy.signal import fftconvolve

    lengths = np.atleast_1d(np.asarray(seconds, np.float64))
    for k, (split, count) in enumerate((("tr", n_train), ("cv", n_val), ("tt", n_test))):
        rng = np.random.default_rng(seed + k)
        base = os.path.join(root, f"wav{fs // 1000}k", "min", split)
        for d in WHAMR_DIRS:
            os.makedirs(os.path.join(base, d), exist_ok=True)
        for i in range(count):
            n = int(lengths[i % len(lengths)] * fs)
            anech, reverb = [], []
            for _ in range(2):
                dry = synth_utterance(make_speaker(rng), rng, fs, n)
                wet = fftconvolve(dry, synth_rir(rng, rng.uniform(0.1, 0.5), fs))[:n]
                anech.append(dry / (np.sqrt(np.mean(dry**2)) + 1e-9))
                reverb.append(wet.astype(np.float32) / (np.sqrt(np.mean(wet**2)) + 1e-9))
            noise = _pink_noise(rng, n)
            sp_pow = np.mean((reverb[0] + reverb[1]) ** 2)
            snr_db = rng.uniform(5.0, 20.0)
            noise *= np.sqrt(sp_pow / (np.mean(noise**2) + 1e-12) / 10 ** (snr_db / 10))
            wavs = dict(s1_anechoic=anech[0], s2_anechoic=anech[1], s1_reverb=reverb[0],
                        s2_reverb=reverb[1], noise=noise,
                        mix_both_reverb=reverb[0] + reverb[1] + noise,
                        mix_both_anechoic=anech[0] + anech[1] + noise)
            for d, x in wavs.items():
                _write_peak(os.path.join(base, d, f"p{i:05d}.wav"), fs, x)
    return root


# -- FUSS: five families of sounds at 16 kHz ----------------------------------

FUSS_FS = 16000


def _env_gates(rng, n, rate_hz, p_on=0.7, smooth_s=0.02):
    n_seg = max(int(rate_hz * n / FUSS_FS), 1)
    gates = (rng.random(n_seg + 1) < p_on) * rng.uniform(0.3, 1.0, n_seg + 1)
    env = np.interp(np.arange(n), np.linspace(0, n - 1, n_seg + 1), gates)
    win = max(1, min(int(smooth_s * FUSS_FS), n))
    return np.convolve(env, np.ones(win) / win, mode="same").astype(np.float32)


def _voice(rng, n):
    return synth_utterance(make_speaker(rng), rng, FUSS_FS, n)


def _tone(rng, n):
    t = np.arange(n) / FUSS_FS
    f0 = rng.uniform(200, 1200)
    vib = 1 + 0.01 * np.sin(2 * np.pi * rng.uniform(4, 7) * t)
    x = sum(rng.uniform(0.2, 1.0) / (k + 1)
            * np.sin(2 * np.pi * f0 * (k + 1) * vib * t + rng.uniform(0, 6.28))
            for k in range(5))
    return (x * _env_gates(rng, n, rng.uniform(0.5, 2.0))).astype(np.float32)


def _resonant_band(x, fc, bw):
    from scipy.signal import lfilter

    r = np.exp(-np.pi * bw / FUSS_FS)
    return lfilter([1.0], [1.0, -2 * r * np.cos(2 * np.pi * fc / FUSS_FS), r * r],
                   x).astype(np.float32)


def _noiseband(rng, n):
    x = rng.standard_normal(n).astype(np.float32)
    x = _resonant_band(x, rng.uniform(500, 6000), rng.uniform(200, 800))
    return x * _env_gates(rng, n, rng.uniform(1.0, 4.0), p_on=0.5)


def _chirp(rng, n):
    t = np.arange(n) / FUSS_FS
    period = rng.uniform(0.4, 1.2)
    f_lo, f_hi = rng.uniform(300, 800), rng.uniform(2000, 7000)
    f = f_lo * (f_hi / f_lo) ** ((t % period) / period)
    phase = 2 * np.pi * np.cumsum(f) / FUSS_FS
    return (np.sin(phase) * _env_gates(rng, n, 1.0 / period)).astype(np.float32)


def _clicks(rng, n):
    x = np.zeros(n, np.float32)
    decay = np.exp(-np.arange(int(0.05 * FUSS_FS))
                   / (rng.uniform(0.002, 0.01) * FUSS_FS)).astype(np.float32)
    for _ in range(rng.integers(4, 20)):
        pos = rng.integers(0, n - len(decay))
        x[pos : pos + len(decay)] += rng.uniform(0.3, 1.0) * decay * rng.choice([-1, 1])
    return _resonant_band(x, rng.uniform(1000, 7000), 600)


FUSS_FAMILIES = (_voice, _tone, _noiseband, _chirp, _clicks)


def write_fuss_corpus(root: str, n_train: int = 16, n_val: int = 8, n_eval: int = 8,
                      seconds: float = 4.0, max_sources: int = 4, seed: int = 0) -> str:
    """Write a FUSS-layout corpus at 16 kHz: ``root/{split}/ex*_src*.wav``,
    their sum ``ex*_mix.wav`` and ``root/{split}_example_list.txt`` of lines
    ``mixture src1 src2 ...``. Each example mixes 1 to ``max_sources`` sounds
    of distinct families at RMS 0.3-1 (uniform counts in train; the counts
    cycle in validation and eval, so every per-count set is filled). Split k
    is drawn from ``seed + k``. Returns ``root``."""
    n = int(seconds * FUSS_FS)
    for k, (split, count) in enumerate(
            (("train", n_train), ("validation", n_val), ("eval", n_eval))):
        rng = np.random.default_rng(seed + k)
        os.makedirs(os.path.join(root, split), exist_ok=True)
        lines = []
        for i in range(count):
            n_src = (int(rng.integers(1, max_sources + 1)) if split == "train"
                     else 1 + i % max_sources)
            fams = rng.choice(len(FUSS_FAMILIES), size=n_src, replace=False)
            srcs = [FUSS_FAMILIES[f](rng, n) for f in fams]
            srcs = [s / (np.sqrt(np.mean(s**2)) + 1e-9) * rng.uniform(0.3, 1.0)
                    for s in srcs]
            names = []
            for j, s in enumerate(srcs):
                rel = f"{split}/ex{i:05d}_src{j}.wav"
                _write_peak(os.path.join(root, rel), FUSS_FS, s)
                names.append(rel)
            mix_rel = f"{split}/ex{i:05d}_mix.wav"
            _write_peak(os.path.join(root, mix_rel), FUSS_FS, np.sum(srcs, axis=0))
            lines.append(" ".join([mix_rel] + names))
        with open(os.path.join(root, f"{split}_example_list.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return root
