"""Experiment tracking and metric reporting (counterpart of
``sudo_rm_rf_tpu/utils/logging.py``).

The primary backend is a local JSONL + npy directory (works offline,
machine-readable); a CometML backend attaches when the ``comet_ml`` package
is importable and ``use_comet`` is set.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np


def report_losses_mean_and_std(res_dic: Dict, experiment=None, tr_step=0, val_step=0):
    """Aggregate accumulated per-sample losses into mean/std and report.

    Each entry of ``res_dic`` holds an ``acc`` list of per-sample values;
    names starting with 'tr' go to the train context, others to validation.
    """
    for l_name in res_dic:
        values = np.array(res_dic[l_name]["acc"], dtype=np.float64)
        res_dic[l_name]["mean"] = float(values.mean()) if values.size else 0.0
        res_dic[l_name]["std"] = float(values.std()) if values.size else 0.0
    if experiment is not None:
        train_metrics = {
            k: v["mean"] for k, v in res_dic.items() if k.startswith("tr")
        }
        val_metrics = {
            k: v["mean"] for k, v in res_dic.items() if not k.startswith("tr")
        }
        experiment.log_metrics(train_metrics, context="train", step=tr_step)
        experiment.log_metrics(val_metrics, context="validate", step=val_step)
    return res_dic


class ExperimentLogger:
    """Local-first experiment tracker with a CometML-compatible surface.

    Writes: <dir>/hparams.json, <dir>/metrics.jsonl (one JSON object per
    log_metrics call), <dir>/<metric>/epoch_<n>.npy raw per-sample arrays.
    """

    def __init__(
        self,
        log_dir: str,
        experiment_name: str = "experiment",
        tags: Optional[List[str]] = None,
        use_comet: bool = False,
        comet_api_key: Optional[str] = None,
        comet_project: Optional[str] = None,
    ):
        self.log_dir = os.path.join(log_dir, experiment_name)
        os.makedirs(self.log_dir, exist_ok=True)
        self.experiment_name = experiment_name
        self.tags = list(tags or [])
        self._metrics_fh = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")

        self._comet = None
        if use_comet:
            try:
                from comet_ml import Experiment  # optional dependency

                self._comet = Experiment(
                    comet_api_key, project_name=comet_project, auto_output_logging=None
                )
                self._comet.set_name(experiment_name)
                for t in self.tags:
                    self._comet.add_tag(t)
            except Exception as exc:  # comet not installed / offline
                print(f"[logger] CometML unavailable ({exc}); local-only logging")

    def get_key(self) -> str:
        return self.experiment_name

    def get_tags(self) -> List[str]:
        return self.tags

    def log_parameters(self, hparams: Dict):
        safe = {k: v for k, v in hparams.items() if _jsonable(v)}
        with open(os.path.join(self.log_dir, "hparams.json"), "w") as fh:
            json.dump(safe, fh, indent=2, default=str)
        if self._comet is not None:
            self._comet.log_parameters(hparams)

    def log_metrics(self, metrics: Dict[str, float], context: str = "train", step: int = 0):
        rec = {
            "ts": time.time(),
            "context": context,
            "step": step,
            **{k: float(v) for k, v in metrics.items()},
        }
        self._metrics_fh.write(json.dumps(rec) + "\n")
        self._metrics_fh.flush()
        if self._comet is not None:
            ctx = (
                self._comet.train if context == "train" else self._comet.validate
            )
            with ctx():
                self._comet.log_metrics(metrics, step=step)

    def log_audio(self, path: str, sample_rate: int = 8000, step: int = 0):
        """Upload a wav to the attached backend (local files are the primary
        record)."""
        if self._comet is not None:
            self._comet.log_audio(path, sample_rate=sample_rate, step=step)

    def log_asset(self, path: str, overwrite: bool = True):
        """Upload an arbitrary artifact, e.g. the best-model checkpoint."""
        if self._comet is not None:
            self._comet.log_asset(path, overwrite=overwrite)

    def log_metric_array(self, name: str, values, epoch: int):
        """Raw per-sample metric arrays, epoch_<n>.npy per metric dir."""
        metric_dir = os.path.join(self.log_dir, name)
        os.makedirs(metric_dir, exist_ok=True)
        path = os.path.join(metric_dir, f"epoch_{epoch}.npy")
        np.save(path, np.asarray(values))
        if self._comet is not None:
            self._comet.log_asset(path, overwrite=True)
        return path

    def close(self):
        self._metrics_fh.close()
        if self._comet is not None:
            self._comet.end()


def _jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False
