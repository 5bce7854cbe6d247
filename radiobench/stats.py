"""The yardstick's percentile: of all samples, interpolating linearly
between order statistics (numpy's default)."""

from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of every value."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


__all__ = ["percentile"]
