"""File+stream logger and JSONL metric writer (port of
alignq_tpu/utils/logging_utils.py)."""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Mapping, Optional


def get_logger(file_path: Optional[str] = None, name: str = "alignq_torch") -> logging.Logger:
    """A logger to stderr and, the first time a path is given, to that file."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s | %(message)s", "%m/%d %H:%M:%S")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if file_path:
        os.makedirs(os.path.dirname(file_path), exist_ok=True)
        fh = logging.FileHandler(file_path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def dump_config(cfg, job_dir: str) -> str:
    """Write the run's config dataclass to job_dir/config.json."""
    os.makedirs(job_dir, exist_ok=True)
    path = os.path.join(job_dir, "config.json")
    rec = {k: (list(v) if isinstance(v, tuple) else v) for k, v in dataclasses.asdict(cfg).items()}
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


class MetricWriter:
    """Append-only JSONL scalar stream, one file per split (job_dir/run/)."""

    def __init__(self, job_dir: str, split: str):
        os.makedirs(os.path.join(job_dir, "run"), exist_ok=True)
        self.path = os.path.join(job_dir, "run", f"{split}.jsonl")
        self._f = open(self.path, "a", buffering=1)

    def write(self, step: int, scalars: Mapping[str, float]):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()
