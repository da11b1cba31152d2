"""Experiment names and log files (counterpart of
``ggp_tpu/utils/experiment_tools.py``).

Every run gets a deterministic name from its (model, data set, split,
configuration), so that log files identify themselves; its metrics go to
``LOG_DIR/<date>/<name>.json``.
"""

from __future__ import annotations

import json
import os
from datetime import date
from typing import Optional

from ..config import LOG_DIR

__all__ = ["ExperimentName", "experiment_name", "experiment_log_path",
           "dump_experiment_json"]


class ExperimentName:
    """Chained builder of ``base_key-value_...`` names."""

    def __init__(self, base: str):
        self.parts = [str(base)]

    def add(self, key: str, value) -> "ExperimentName":
        self.parts.append(f"{key}-{value}")
        return self

    def get(self) -> str:
        return "_".join(self.parts)


def experiment_name(model_name: str, dataset_name: str, split_index: int = 0,
                    **fields) -> str:
    """``<dataset>_model-<model>_split-<i>`` and then the fields that are
    not None: M, max_iters, num_epochs, batch_size, tune, num_samples,
    num_chains and seed in that order, the others sorted by name."""
    e = ExperimentName(dataset_name).add("model", model_name).add("split", split_index)
    order = ["M", "max_iters", "num_epochs", "batch_size", "tune",
             "num_samples", "num_chains", "seed"]
    for k in order:
        if k in fields and fields[k] is not None:
            e.add(k, fields[k])
    for k in sorted(set(fields) - set(order)):
        if fields[k] is not None:
            e.add(k, fields[k])
    return e.get()


def experiment_log_path(name: str, subdir: Optional[str] = None) -> str:
    """``LOG_DIR/<date>[/subdir]/<name>.json``; the directory is made."""
    d = os.path.join(LOG_DIR, date.today().isoformat())
    if subdir:
        d = os.path.join(d, subdir)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{name}.json")


def dump_experiment_json(name: str, metrics: dict, subdir: Optional[str] = None) -> str:
    """Write ``metrics`` to :func:`experiment_log_path`; returns the path."""
    path = experiment_log_path(name, subdir)
    with open(path, "w") as f:
        json.dump(metrics, f, indent=2, default=float)
    return path
