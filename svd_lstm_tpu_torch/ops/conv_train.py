"""Kernel training paths for the Conv1D + LSTM hybrid families.

Counterpart of ``svd_lstm_tpu/ops/conv_train.py``. The causal conv has
nothing recurrent about it, so a hybrid's training step is

    h = relu(causal_conv1d(conv, x))        # one F.conv1d and its autograd
    y = <the stack's kernel train apply>(inner, h)

and the conv's gradients come from the train kernels' dx, which autograd
carries back through the conv. The stack runs the pure families' kernel
dispatch (``ops/cuda_train.stacked_lstm_apply_fast_train``, with
``compact="auto"``):

* ``ConvLSTM``: the dense stack itself;
* ``ConvSingularLSTM``: the factors' dense view
  (``ops/singular_train.singular_dense_view``);
* ``ConvReducedLSTM``: the two-step factors' dense view
  (``ops/reduced_train.reduced_dense_view``).

The conv's product follows the training regime, as the x-side product
does (``utils.precision.product`` under ``train_matmul_scope``: bf16
operands in "bfloat16", cuDNN's TF32 in "tensorfloat32", exact otherwise).
``bf16`` picks the kernels' bf16-operand variants. The JAX package's
batch chunking (``chunked_fast_train``) works around a TPU compiler limit
and is not carried over. x_seq (B, T, in_channels) -> (B, T, out), or
(B, out) for the last step.
"""

from __future__ import annotations

import torch

from svd_lstm_tpu_torch.models.conv import (
    ConvLSTM,
    ConvReducedLSTM,
    ConvSingularLSTM,
    conv_front,
)
from svd_lstm_tpu_torch.ops.cuda_train import stacked_lstm_apply_fast_train
from svd_lstm_tpu_torch.ops.reduced_train import reduced_dense_view
from svd_lstm_tpu_torch.ops.singular_train import singular_dense_view


def conv_lstm_apply_fast_train(model: ConvLSTM, x_seq: torch.Tensor,
                               return_sequences: bool = True, bf16: bool = False):
    """Training apply of the dense hybrid through the train kernels."""
    return stacked_lstm_apply_fast_train(model.stack, conv_front(model.conv, x_seq),
                                         return_sequences, bf16=bf16)


def conv_singular_apply_fast_train(model: ConvSingularLSTM, x_seq: torch.Tensor,
                                   return_sequences: bool = True, bf16: bool = False):
    """Training apply of the factorized hybrid (the σ fine-tune) through the
    train kernels, on the stack's differentiable dense view."""
    return stacked_lstm_apply_fast_train(singular_dense_view(model.inner),
                                         conv_front(model.conv, x_seq), return_sequences,
                                         bf16=bf16)


def conv_reduced_apply_fast_train(model: ConvReducedLSTM, x_seq: torch.Tensor,
                                  return_sequences: bool = True, bf16: bool = False):
    """Training apply of the truncated hybrid (the recovery) through the
    train kernels, on the stack's differentiable dense view."""
    return stacked_lstm_apply_fast_train(reduced_dense_view(model.inner),
                                         conv_front(model.conv, x_seq), return_sequences,
                                         bf16=bf16)
