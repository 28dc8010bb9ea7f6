"""Run-dir management, logging, and metric history.

Behavioral spec: reference misc/utils.py — set_seed (:78-85), build_floder
(:106-128, timestamp-renames an existing unfinished run dir), backup_envir
(:131-137), create_logger (:140-167). TensorboardX scalars are replaced by a
metrics.jsonl stream (greppable, no extra deps); a tensorboard writer is used
when the package is importable.

The port's copy of gvl_tpu/utils/logging.py; `set_seed` also seeds torch.
"""

from __future__ import annotations

import json
import logging
import os
import random
import shutil
import time
from typing import Dict, Optional

import numpy as np
import torch


def set_seed(seed: int):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def build_folder(cfg) -> str:
    save_folder = os.path.join(cfg.save_dir, cfg.id)
    if cfg.start_from:
        assert os.path.exists(save_folder), \
            f"resume requested but {save_folder} is missing"
    elif os.path.exists(save_folder):
        stamp = time.strftime("%Y-%m-%d_%H-%M-%S", time.localtime())
        shutil.move(save_folder, save_folder + "_" + stamp)
    os.makedirs(save_folder, exist_ok=True)
    return save_folder


def backup_envir(save_folder: str, repo_root: Optional[str] = None):
    """Copy the source tree into the run dir for reproducibility."""
    repo_root = repo_root or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    backup = os.path.join(save_folder, "backup")
    os.makedirs(backup, exist_ok=True)
    for rel in ["gvl_tpu_torch", "cfgs"]:
        src = os.path.join(repo_root, rel)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(backup, rel),
                            dirs_exist_ok=True,
                            ignore=shutil.ignore_patterns("__pycache__"))
    for f in os.listdir(repo_root):
        if f.endswith(".py"):
            shutil.copy(os.path.join(repo_root, f), backup)


def create_logger(folder: str, filename: str = "train.log") -> logging.Logger:
    logger = logging.getLogger(folder)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    fh = logging.FileHandler(os.path.join(folder, filename))
    fh.setFormatter(fmt)
    logger.addHandler(sh)
    logger.addHandler(fh)
    logger.propagate = False
    return logger


class MetricsWriter:
    """Scalar stream: metrics.jsonl (+ tensorboard when available)."""

    def __init__(self, folder: str):
        self.path = os.path.join(folder, "metrics.jsonl")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(os.path.join(folder, "tb"))
        except Exception:
            pass

    def write(self, step: int, scalars: Dict[str, float], prefix: str = ""):
        rec = {"step": step}
        for k, v in scalars.items():
            try:
                rec[prefix + k] = float(v)
            except (TypeError, ValueError):
                continue
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)
