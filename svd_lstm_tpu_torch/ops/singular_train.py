"""Kernel training path for the SVD-factorized (singular) model.

Counterpart of ``svd_lstm_tpu/ops/singular_train.py``. Every weight matrix
of a singular model is linear in each of its factors,

    W = (U_w · diag(σ_w)) · V_wᵀ   (per matrix, or per gate when split),

so the σ fine-tune reconstructs the dense weights inside the step and runs
them through the dense train kernels (K7, K9 in ``ops/cuda_train.py``):
the kernels' backward gives dW/dU/db, and torch autograd of the
reconstruction carries them on to (wl, ws, wr, ul, us, ur). No factored
recurrence kernel is needed. The reconstruction is two small products per
layer per step, computed in float32 with TF32 off, forward and backward, in
every training regime (``utils.precision.exact_products``): the JAX
package runs it at HIGHEST, since its product is the model's weight
matrix. ``bf16`` picks the kernels' bf16-operand variants, as for the dense
model.

The JAX package split batches past B = 512 into ~256-row kernel instances
and kept wide stacks above B = 128 on the XLA scan, both to avoid TPU
compiler failures. Neither limit exists here: the view goes straight to the
dense training dispatch.
"""

from __future__ import annotations

import torch

from svd_lstm_tpu_torch.factor.svd import _dense_matrix
from svd_lstm_tpu_torch.models.singular import SingularLSTM
from svd_lstm_tpu_torch.ops.cuda_train import DenseView, LayerView, stacked_lstm_apply_fast_train
from svd_lstm_tpu_torch.utils.precision import exact_products


def singular_dense_view(smodel: SingularLSTM) -> DenseView:
    """Differentiable dense reconstruction of a singular model: the same
    math as ``factor.svd.singular_to_dense``, but the tensors stay in the
    autograd graph of the factors."""
    layers = tuple(
        LayerView(
            W=exact_products(_dense_matrix, p.wl, p.ws, p.wr),
            U=exact_products(_dense_matrix, p.ul, p.us, p.ur),
            b=p.b,
        )
        for p in smodel.layers
    )
    return DenseView(layers=layers, head=smodel.head)


def singular_lstm_apply_fast_train(
    smodel: SingularLSTM, x_seq: torch.Tensor, return_sequences: bool = True, bf16: bool = False
) -> torch.Tensor:
    """Drop-in training apply for the singular fine-tune through the dense
    train kernels (their bf16-operand variants with ``bf16``). x_seq (B, T,
    d) -> (B, T, out) / (B, out)."""
    return stacked_lstm_apply_fast_train(singular_dense_view(smodel), x_seq, return_sequences,
                                         bf16=bf16)
