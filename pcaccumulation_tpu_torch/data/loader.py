"""Batch collation over static-shape samples: every sample is already
padded to the static capacities, so collation is a plain stack."""

from __future__ import annotations

import numpy as np


def collate(samples: list[dict]) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
