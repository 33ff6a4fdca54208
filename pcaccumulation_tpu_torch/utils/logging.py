"""Append-file logger, JSONL scalar stream and seeding (the port's copy of
the JAX package's `utils/logging.py`, with torch seeded too)."""

from __future__ import annotations

import json
import os
import random

import numpy as np
import torch


class Logger:
    def __init__(self, save_dir: str | None, also_print: bool = True):
        self.path = None
        self.also_print = also_print
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            self.path = os.path.join(save_dir, "log")

    def write(self, text: str):
        if self.path:
            with open(self.path, "a") as f:
                f.write(text)
        if self.also_print:
            print(text, end="" if text.endswith("\n") else "\n")


class MetricsWriter:
    """Append-only JSONL scalar stream: one line per logging event,
    {"step": global_iter, "phase": ..., "<scalar>": value, ...}."""

    def __init__(self, save_dir: str | None):
        self.path = None
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            self.path = os.path.join(save_dir, "metrics.jsonl")

    def write(self, step: int, phase: str, scalars: dict):
        if not self.path:
            return
        rec = {"step": int(step), "phase": phase}
        for k, v in scalars.items():
            rec[k] = float(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def setup_seed(seed: int):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
