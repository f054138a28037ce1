"""Dataset dispatch (counterpart of ``sudo_rm_rf_tpu/data/setup.py``): name ->
loader class, root path, split translation.

The port loads WHAM, WHAMR, FUSS, LIBRI2MIX, MUSDB (its root by rate:
``musdb8k_root`` at 8 kHz, else ``musdb_root``) and the AUGMENTED_*
hierarchical online-mixing sets. The FUSS val and test splits become one
generator per source count, keyed ``{split}_{n}_srcs``, each scored with its
own stabilized metric.
"""

from __future__ import annotations

from typing import Dict, Optional

from sudo_rm_rf_tpu_torch import config as cfg

_SPLIT_TRANSLATORS = {
    "WHAM": {"train": "tr", "test": "tt", "val": "cv"},
    "WHAMR": {"train": "tr", "test": "tt", "val": "cv"},
    "FUSS": {"train": "train", "test": "eval", "val": "validation"},
    "MUSDB": {"train": "train", "test": "test", "val": "test"},
}


def create_loader_for_simple_dataset(
    dataset_name: str,
    separation_task: Optional[str] = None,
    data_split: str = "train",
    sample_rate: int = 8000,
    min_or_max: str = "min",
    zero_pad: bool = True,
    timelength: float = 4.0,
    n_channels: int = 1,
    normalize_audio: bool = False,
    n_samples: int = 0,
    min_num_sources: int = 1,
    max_num_sources: int = 4,
    root_dirpath: Optional[str] = None,
):
    """Build one dataset. ``root_dirpath`` overrides the configured root."""
    from sudo_rm_rf_tpu_torch.data.fuss import FUSSDataset
    from sudo_rm_rf_tpu_torch.data.libri2mix import LibriMixDataset
    from sudo_rm_rf_tpu_torch.data.musdb import MusdbDataset
    from sudo_rm_rf_tpu_torch.data.wham import WhamDataset
    from sudo_rm_rf_tpu_torch.data.whamr import WhamRDataset

    common = dict(sample_rate=int(sample_rate), timelength=float(timelength),
                  zero_pad=zero_pad, n_samples=int(n_samples))
    augment = "tr" in data_split or data_split == "train"

    if dataset_name == "WHAM":
        root = root_dirpath or cfg.paths.wham_root
        return WhamDataset(
            root_dirpath=root, task=separation_task,
            split=_SPLIT_TRANSLATORS["WHAM"][data_split],
            min_or_max=min_or_max, augment=augment,
            normalize_audio=normalize_audio, **common,
        )
    if dataset_name == "WHAMR":
        root = root_dirpath or cfg.paths.whamr_root
        return WhamRDataset(
            root_dirpath=root, task=separation_task,
            split=_SPLIT_TRANSLATORS["WHAMR"][data_split],
            min_or_max=min_or_max, augment=augment, **common,
        )
    if dataset_name == "FUSS":
        root = root_dirpath or cfg.paths.fuss_root
        return FUSSDataset(
            root_dirpath=root, split=_SPLIT_TRANSLATORS["FUSS"][data_split],
            augment=augment, min_num_sources=min_num_sources,
            max_num_sources=max_num_sources, **common,
        )
    if dataset_name == "LIBRI2MIX":
        root = root_dirpath or cfg.paths.libri2mix_root
        if data_split == "train":
            # train-100 / train-360 by the requested size, as the reference
            split = "train-360" if n_samples > 13900 else "train-100"
        elif data_split == "test":
            split = "test"
        else:
            split = "dev"
        return LibriMixDataset(
            root_dirpath=root, task=separation_task, split=split,
            min_or_max=min_or_max, normalize_audio=normalize_audio, **common,
        )
    if dataset_name == "MUSDB":
        root = root_dirpath or (
            cfg.paths.musdb8k_root if sample_rate == 8000 else cfg.paths.musdb_root)
        return MusdbDataset(
            root_dirpath=root, split=_SPLIT_TRANSLATORS["MUSDB"][data_split],
            augment=augment, n_channels=n_channels, **common,
        )
    raise ValueError(f"Dataset: {dataset_name} is not yet supported!")


def create_augmented_loader(hparams: Dict, split: str = "train"):
    """An AUGMENTED_* split: online mixing over hierarchical roots with
    per-dataset priors. hparams keys: ``{split}_dataset_paths`` (the roots),
    optional ``datasets_priors``, ``n_{split}``, ``max_abs_snr``, ``fs``,
    ``audio_timelength``, ``n_sources``, ``fixed_seed`` (default: 0, fresh
    draws each epoch, for train; 42, fixed mixtures, for val and test)."""
    from sudo_rm_rf_tpu_torch.data.hierarchical import AugmentedOnlineMixingDataset

    paths = hparams[f"{split}_dataset_paths"]
    fixed_default = 0 if split == "train" else 42
    return AugmentedOnlineMixingDataset(
        input_dataset_p=list(paths),
        datasets_priors=list(hparams.get("datasets_priors", [1.0 / len(paths)] * len(paths))),
        n_sources=hparams.get("n_sources", 2),
        n_samples=hparams.get(f"n_{split}", 1000),
        max_abs_snr=hparams.get("max_abs_snr", 2.5),
        sample_rate=int(hparams.get("fs", 8000)),
        selected_timelength=float(hparams.get("audio_timelength", 4.0)),
        fixed_seed=hparams.get("fixed_seed", fixed_default),
    )


def setup(hparams: Dict) -> Dict:
    """Build {train, val, test, train_val} generators from an hparams dict."""
    generators = {}
    for data_split in ["train", "val", "test", "train_val"]:
        names = hparams.get(data_split)
        if not names:
            generators[data_split] = None
            continue
        if len(names) > 1:
            raise ValueError(
                "Current implementation does not support training using "
                "multiple datasets."
            )
        if names[0].startswith("AUGMENTED"):
            if not hparams.get(f"{data_split}_dataset_paths"):
                generators[data_split] = None
                continue
            ds = create_augmented_loader(hparams, data_split)
            generators[data_split] = ds.get_generator(
                batch_size=hparams["batch_size"],
                num_workers=hparams.get("n_jobs", 4),
                shuffle=data_split == "train",
                # two batches beyond the steps a dispatch takes, as in JAX
                prefetch=max(2, int(hparams.get("chain_steps", 1)) + 2),
            )
            continue
        if names[0] == "FUSS" and data_split in ("val", "test"):
            generators[data_split] = None
            for n in range(int(hparams.get("min_num_sources", 1)),
                           int(hparams.get("max_num_sources", 4)) + 1):
                loader = create_loader_for_simple_dataset(
                    dataset_name="FUSS",
                    separation_task=hparams.get("separation_task"),
                    data_split=data_split,
                    sample_rate=hparams["fs"],
                    zero_pad=hparams.get("zero_pad_audio", True),
                    timelength=hparams["audio_timelength"],
                    normalize_audio=hparams.get("normalize_audio", False),
                    min_num_sources=n,
                    max_num_sources=n,
                    root_dirpath=hparams.get("fuss_root"),
                )
                # evaluation keeps the last partial batch
                generators[f"{data_split}_{n}_srcs"] = loader.get_generator(
                    batch_size=hparams["batch_size"],
                    num_workers=hparams.get("n_jobs", 4),
                    shuffle=False,
                    drop_last=False,
                )
            continue
        loader = create_loader_for_simple_dataset(
            dataset_name=names[0],
            separation_task=hparams.get("separation_task"),
            data_split=data_split.split("_")[0],
            sample_rate=hparams["fs"],
            n_channels=hparams.get("n_channels", 1),
            min_or_max=hparams.get("min_or_max", "min"),
            zero_pad=hparams.get("zero_pad_audio", True),
            timelength=hparams["audio_timelength"],
            normalize_audio=hparams.get("normalize_audio", False),
            n_samples=hparams.get("n_" + data_split, 0),
            min_num_sources=hparams.get("min_num_sources", 1),
            max_num_sources=hparams.get("max_num_sources", 4),
            root_dirpath=hparams.get(f"{names[0].lower()}_root"),
        )
        generators[data_split] = loader.get_generator(
            batch_size=hparams["batch_size"],
            num_workers=hparams.get("n_jobs", 4),
            shuffle=data_split == "train",
        )
    return generators
