"""Small WHAM-, WHAMR!-, FUSS-, MUSDB- and hierarchical-layout corpora of synthetic
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
five distinct families (``scripts/make_synthetic_fuss.py``); the MUSDB corpus
holds tracks of four synthetic stems, drums, bass, chords and a voice
(``scripts/make_synthetic_musdb.py``). Imports numpy and scipy only.
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
                wet = wet.astype(np.float32)
                anech.append(dry / (np.sqrt(np.mean(dry**2)) + 1e-9))
                reverb.append(wet / (np.sqrt(np.mean(wet**2)) + 1e-9))
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
    n_clicks = rng.integers(4, 20)  # drawn before the decay, as the script draws them
    decay = np.exp(-np.arange(int(0.05 * FUSS_FS))
                   / (rng.uniform(0.002, 0.01) * FUSS_FS)).astype(np.float32)
    for _ in range(n_clicks):
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


# -- MUSDB ----------------------------------------------------------------------

MUSDB_CHORDS = ([0, 4, 7], [0, 3, 7], [0, 5, 9], [0, 4, 9])  # triads of a chord loop
MUSDB_GAINS = {"drums": 0.35, "bass": 0.3, "other": 0.25, "vocals": 0.4}


def _note_hz(semitones_from_a1: float) -> float:
    return 55.0 * 2.0 ** (semitones_from_a1 / 12.0)


def _adsr(n: int, attack: float, decay: float, fs: int) -> np.ndarray:
    """A linear attack then an exponential decay, ``n`` samples."""
    a = min(int(attack * fs), n)
    e = np.ones(n, np.float32)
    if a > 0:
        e[:a] = np.linspace(0, 1, a)
    e *= np.exp(-np.arange(n) / (decay * fs)).astype(np.float32)
    return e


def synth_drums(rng: np.random.Generator, fs: int, n: int, bpm: float) -> np.ndarray:
    """A kick (a falling 60 Hz sine burst) on every beat, a snare (a
    resonant noise burst) on the off-beats and closed hats (differenced
    noise ticks) at twice the beat rate."""
    from scipy.signal import lfilter

    beat = int(60.0 / bpm * fs)
    x = np.zeros(n, np.float32)
    for i in range(0, n, beat):
        m = min(int(0.12 * fs), n - i)
        tt = np.arange(m) / fs
        x[i:i + m] += 0.9 * np.sin(2 * np.pi * (60.0 * tt - 30.0 * tt * tt)).astype(
            np.float32) * _adsr(m, 0.001, 0.05, fs)
    for i in range(beat // 2, n, beat):
        m = min(int(0.08 * fs), n - i)
        noise = rng.standard_normal(m).astype(np.float32)
        b, a = _resonator(1800.0, 800.0, fs)
        x[i:i + m] += 0.5 * lfilter(b, a, noise).astype(np.float32) * _adsr(m, 0.0005, 0.03, fs)
    for i in range(0, n, beat // 2):
        m = min(int(0.03 * fs), n - i)
        noise = rng.standard_normal(m).astype(np.float32)
        hp = noise - np.concatenate([[0.0], noise[:-1]])
        x[i:i + m] += 0.25 * hp.astype(np.float32) * _adsr(m, 0.0002, 0.01, fs)
    return x


def synth_bass(rng: np.random.Generator, fs: int, n: int, bpm: float, chords,
               root: float) -> np.ndarray:
    """The chord loop's root an octave down, one note a beat, three odd
    harmonics."""
    beat = int(60.0 / bpm * fs)
    bar = 4 * beat
    x = np.zeros(n, np.float32)
    for i in range(0, n, beat):
        f0 = _note_hz(root + chords[(i // bar) % len(chords)][0] - 12)
        m = min(beat, n - i)
        tt = np.arange(m) / fs
        tone = sum((1.0 / (2 * k + 1)) * np.sin(2 * np.pi * f0 * (2 * k + 1) * tt)
                   for k in range(3))
        x[i:i + m] += 0.7 * tone.astype(np.float32) * _adsr(m, 0.005, 0.4, fs)
    return x


def synth_other(rng: np.random.Generator, fs: int, n: int, bpm: float, chords,
                root: float) -> np.ndarray:
    """Sustained triads of the chord loop, a bar each, three harmonics a
    voice with vibrato and a random detune."""
    beat = int(60.0 / bpm * fs)
    bar = 4 * beat
    x = np.zeros(n, np.float32)
    for i in range(0, n, bar):
        chord = chords[(i // bar) % len(chords)]
        m = min(bar, n - i)
        tt = np.arange(m) / fs
        vib = 1.0 + 0.004 * np.sin(2 * np.pi * 5.0 * tt)
        seg = np.zeros(m, np.float32)
        for semi in chord:
            f0 = _note_hz(root + semi + 12)
            detune = 1.0 + rng.uniform(-0.002, 0.002)
            for h in range(1, 4):
                seg += (0.3 / h) * np.sin(2 * np.pi * f0 * detune * h * tt * vib).astype(
                    np.float32)
        x[i:i + m] += seg * _adsr(m, 0.05, 2.0, fs)
    return x


def synth_vocals(rng: np.random.Generator, fs: int, n: int) -> np.ndarray:
    """Phrases of one synthetic voice, 2-5 s each, with 0.2-1 s rests."""
    spk = make_speaker(rng)
    out = np.zeros(n, np.float32)
    pos = 0
    while pos < n:
        m = min(int(rng.uniform(2.0, 5.0) * fs), n - pos)
        out[pos:pos + m] = synth_utterance(spk, rng, fs, m)
        pos += m + int(rng.uniform(0.2, 1.0) * fs)
    return out


def write_track(track_dir: str, rng: np.random.Generator, fs: int, seconds: float) -> None:
    """One track's four stems, each peak-normalized to its gain, and their
    exact sum as ``mixture.wav`` (int16 at 32000 x the sample)."""
    from scipy.io import wavfile

    os.makedirs(track_dir, exist_ok=True)
    n = int(seconds * fs)
    bpm = float(rng.uniform(80, 140))
    root = float(rng.uniform(0, 12))
    chords = [MUSDB_CHORDS[int(rng.integers(len(MUSDB_CHORDS)))] for _ in range(4)]
    stems = {
        "drums": synth_drums(rng, fs, n, bpm),
        "bass": synth_bass(rng, fs, n, bpm, chords, root),
        "other": synth_other(rng, fs, n, bpm, chords, root),
        "vocals": synth_vocals(rng, fs, n),
    }
    mixture = np.zeros(n, np.float32)
    for name, wav in stems.items():
        wav = (MUSDB_GAINS[name] * wav / (np.abs(wav).max() + 1e-9)).astype(np.float32)
        stems[name] = wav
        mixture += wav
    stems["mixture"] = mixture
    for name, wav in stems.items():
        wavfile.write(os.path.join(track_dir, f"{name}.wav"), fs, (wav * 32000).astype(np.int16))


def write_musdb_corpus(root: str, train_tracks: int = 60, test_tracks: int = 12,
                       fs: int = 8000, seconds: float = 30.0, seed: int = 0) -> str:
    """Write a MUSDB-layout corpus of synthetic music,
    ``root/{train,test}/track<i>/{mixture,drums,bass,other,vocals}.wav``
    (mono int16), the layout ``data.musdb.MusdbDataset`` reads. Each stem
    family is spectrally and temporally distinct: drums, a bass line and
    sustained triads on a per-track chord loop, and a formant voice. The
    port's copy of ``scripts/make_synthetic_musdb.py``: the same files, bit
    for bit, at the same arguments (train from ``seed``, test from ``seed +
    1``). Returns ``root``."""
    for split, count, split_seed in (("train", train_tracks, seed),
                                     ("test", test_tracks, seed + 1)):
        rng = np.random.default_rng(split_seed)
        for i in range(count):
            write_track(os.path.join(root, split, f"track{i:03d}"), rng, fs, seconds)
    return root
