"""Standard scaling, self-contained (no sklearn dependency at runtime).

Counterpart of ``svd_lstm_tpu/data/scalers.py``, unchanged in behaviour.

Matches `sklearn.preprocessing.StandardScaler` as used by the reference
(code/train_full_model_v4.py:56-62): per-feature zero-mean/unit-variance with
the population (ddof=0) standard deviation, and `inverse_transform` to map
predictions back to physical units.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StandardScaler:
    mean_: np.ndarray | None = None
    scale_: np.ndarray | None = None

    def fit(self, x: np.ndarray) -> "StandardScaler":
        x = np.asarray(x, dtype=np.float64)
        self.mean_ = x.mean(axis=0)
        scale = x.std(axis=0)  # ddof=0, like sklearn
        # sklearn maps zero variance to scale 1 to avoid div-by-zero
        self.scale_ = np.where(scale == 0.0, 1.0, scale)
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x, dtype=np.float64) - self.mean_) / self.scale_

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)

    def inverse_transform(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, dtype=np.float64) * self.scale_ + self.mean_
