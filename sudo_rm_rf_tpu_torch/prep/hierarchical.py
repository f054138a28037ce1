"""Writers of the hierarchical datasets (counterpart of
``sudo_rm_rf_tpu/prep/hierarchical.py``, the same files from the same input).

  * ESC-50 wavs named ``{fold}-{src}-{take}-{class}.wav`` are resampled to
    8 kHz, looped or cropped to ``wav_timelength``, and written one folder
    per sample under their sound-class folder, then partitioned by fold
    (1-4 train, fold 5 split between val and test);
  * wsj0-mix subsets (tr/cv/tt) become per-utterance folders holding
    {mixture, sources} cropped or padded to a fixed length, in a directory
    named ``wsj0_{n}mix_{fs}k_{T}s_{min|max}_preprocessed``;
  * or a per-speaker hierarchy: class folder = speaker id (the first 3
    characters of the utterance name).

Each sample folder holds at least ``wav`` ((1, T) float32, energy-
normalized), the layout ``data.hierarchical.AugmentedOnlineMixingDataset``
reads. Files are written with ``utils.joblib_format.dump``, which writes what
``joblib.dump`` writes; wavs are read with the port's ``data.base.read_wav``.
"""

from __future__ import annotations

import glob
import math
import os
import shutil
from typing import Dict, Optional, Sequence

import numpy as np

from sudo_rm_rf_tpu_torch.data.base import read_wav
from sudo_rm_rf_tpu_torch.utils import joblib_format


def resample_poly(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling via scipy (librosa replacement)."""
    if sr_in == sr_out:
        return wav
    from scipy.signal import resample_poly as _rp

    g = math.gcd(sr_in, sr_out)
    return _rp(wav, sr_out // g, sr_in // g).astype(np.float32)


def _fit_length(wav: np.ndarray, n: int) -> np.ndarray:
    """Loop-pad or crop a 1-D wav to exactly n samples."""
    if wav.shape[0] >= n:
        return wav[:n]
    reps = -(-n // wav.shape[0])
    return np.tile(wav, reps)[:n]


def _dump_sample(folder: str, wav: np.ndarray, extras: Optional[Dict] = None):
    os.makedirs(folder, exist_ok=True)
    energy = np.sqrt(np.sum(wav**2)) + 1e-8
    normed = (wav / energy).astype(np.float32)[None, :]
    joblib_format.dump(normed, os.path.join(folder, "wav"))
    for key, value in (extras or {}).items():
        joblib_format.dump(value, os.path.join(folder, key))


def make_hierarchical_from_wavs(
    wav_paths: Sequence[str],
    class_of: Dict[str, str],
    output_dirpath: str,
    wav_timelength: float,
    sample_rate: int = 8000,
    source_sample_rate: Optional[int] = None,
):
    """Generic writer: wav file -> <out>/<class>/<stem>/wav."""
    n = int(wav_timelength * sample_rate)
    for path in sorted(wav_paths):
        sr, wav = read_wav(path)
        if wav.ndim > 1:
            wav = wav.mean(axis=-1)
        wav = resample_poly(wav, source_sample_rate or sr, sample_rate)
        wav = _fit_length(wav, n)
        stem = os.path.splitext(os.path.basename(path))[0]
        folder = os.path.join(output_dirpath, class_of[os.path.basename(path)], stem)
        _dump_sample(folder, wav)
    return output_dirpath


def convert_esc50_to_hierarchical(
    input_dirpath: str,
    output_dirpath: str,
    wav_timelength: float,
    sample_rate: int = 8000,
):
    """ESC-50 -> hierarchical class folders (`create_esc50_hierarchical.py`).

    Expects <input>/audio/*.wav named {fold}-{src}-{take}-{class}.wav.
    """
    files = glob.glob(os.path.join(input_dirpath, "audio", "*.wav"))
    if not files:
        raise IOError(f"no wavs under {input_dirpath}/audio")
    class_of = {
        os.path.basename(f): os.path.basename(f).split("-")[-1].split(".wav")[0]
        for f in files
    }
    return make_hierarchical_from_wavs(
        files, class_of, output_dirpath, wav_timelength, sample_rate
    )


def partition_esc50(hier_dataset_dirpath: str, partitions_dirpath: str):
    """Fold-based partitioning: folds 1-4 -> train; fold 5 split between
    val and test (`create_esc50_hierarchical.py:160-217`). ESC-50 file stems
    start with the fold number."""
    for class_path in sorted(glob.glob(os.path.join(hier_dataset_dirpath, "*"))):
        class_name = os.path.basename(class_path)
        samples = sorted(glob.glob(os.path.join(class_path, "*")))
        fold5 = [s for s in samples if os.path.basename(s).startswith("5")]
        train = [s for s in samples if not os.path.basename(s).startswith("5")]
        val = fold5[: len(fold5) // 2]
        test = fold5[len(fold5) // 2 :]
        for part, items in (("train", train), ("val", val), ("test", test)):
            for s in items:
                dst = os.path.join(
                    partitions_dirpath, part, class_name, os.path.basename(s)
                )
                if not os.path.exists(dst):
                    shutil.copytree(s, dst)
    return partitions_dirpath


def convert_wsj0mix_to_universal(
    input_dirpath: str,
    output_dirpath: str,
    wav_timelength: float,
    sample_rate: int = 8000,
    n_speakers: int = 2,
    min_or_max: str = "min",
    hierarchical_by_speaker: bool = False,
):
    """wsj0-mix -> per-utterance joblib folders (`preprocess_wsj0mix.py`),
    or per-speaker class hierarchy (`create_wsj0mix_hier_speakers.py`) when
    ``hierarchical_by_speaker``.

    Expects <input>/{tr,cv,tt}/{mix,s1,s2,...}/*.wav.
    """
    out_name = (
        f"wsj0_{n_speakers}mix_{sample_rate // 1000}k_{int(wav_timelength)}s_"
        f"{min_or_max}_" + ("hierarchical" if hierarchical_by_speaker else "preprocessed")
    )
    root_out = os.path.join(output_dirpath, out_name)
    n = int(wav_timelength * sample_rate)
    for subset in sorted(os.listdir(input_dirpath)):
        subset_in = os.path.join(input_dirpath, subset)
        if not os.path.isdir(subset_in):
            continue
        mix_files = sorted(glob.glob(os.path.join(subset_in, "mix", "*.wav")))
        for mix_path in mix_files:
            name = os.path.splitext(os.path.basename(mix_path))[0]
            _, mix = read_wav(mix_path)
            mix = _fit_length(mix, n)
            sources = []
            for s in range(1, n_speakers + 1):
                _, wav = read_wav(
                    os.path.join(subset_in, f"s{s}", os.path.basename(mix_path))
                )
                sources.append(_fit_length(wav, n))
            if hierarchical_by_speaker:
                # speaker id = first 3 chars of each source utterance id
                # (utterance names look like 011a0101_1.2345_20aa010b_-1.2345)
                parts = name.split("_")
                for s, wav in enumerate(sources):
                    spk = parts[2 * s][:3]
                    folder = os.path.join(root_out, subset, spk, f"{name}_s{s + 1}")
                    _dump_sample(folder, wav)
            else:
                folder = os.path.join(root_out, subset, name)
                os.makedirs(folder, exist_ok=True)
                joblib_format.dump(
                    mix.astype(np.float32)[None, :], os.path.join(folder, "mixture_wav")
                )
                for s, wav in enumerate(sources):
                    joblib_format.dump(
                        wav.astype(np.float32)[None, :],
                        os.path.join(folder, f"clean_wav_{s}"),
                    )
                energy = np.sqrt(np.sum(mix**2)) + 1e-8
                joblib_format.dump(
                    (mix / energy).astype(np.float32)[None, :],
                    os.path.join(folder, "wav"),
                )
    return root_out
