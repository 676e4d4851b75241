"""A forward step of the flagship model and its example arguments.

Counterpart of ``__graft_entry__.py``'s ``entry()``: the reference's
4x40 stacked LSTM regressor (the train_full_model_v4 configuration), seeded
with 0, and a batch of 8 windows of 200 frames of 16 features from
``np.random.default_rng(0)``. The model and x are on ``device``: the card
unless the caller asks for the CPU.

    forward, (model, x) = entry()
    y = forward(model, x)   # (8, 1): the window-end predictions
"""

from __future__ import annotations

import numpy as np
import torch

from svd_lstm_tpu_torch.models.lstm import init_stacked_lstm, stacked_lstm_apply


def forward(model, x: torch.Tensor) -> torch.Tensor:
    """The window-end prediction of every window: (B, T, d) -> (B, 1)."""
    return stacked_lstm_apply(model, x, return_sequences=False)


def entry(device="cuda"):
    """``(forward, (model, x))``: the 4x40 stack of seed 0 and x (8, 200,
    16), standard normal from numpy's seed 0, both on ``device``."""
    model = init_stacked_lstm(torch.Generator().manual_seed(0), input_dim=16, units=(40, 40, 40, 40),
                              device=device)
    x = torch.tensor(np.random.default_rng(0).normal(size=(8, 200, 16)), dtype=torch.float32,
                     device=device)
    return forward, (model, x)
