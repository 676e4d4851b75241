"""svd_lstm_tpu_torch — the PyTorch + CUDA port of ``svd_lstm_tpu``.

On an NVIDIA H100: train a stacked-LSTM regressor (``fit``), factorize it
(U·Σ·Vᵀ), fine-tune σ under the Hoyer penalty (``finetune``), truncate to
the exact two-step form ``(x·B)·[I|C]``, and predict with the dense or the
reduced model at batch 1 or batched (``precision="exact"``, ``"high"`` or
``"fast"``). The batch-1 recurrences (exact and bf16-operand), the batched fast-mode
recurrence and the training recurrences (forward and backward) run in
hand-written CUDA kernels (``ops/csrc``); everything else is plain PyTorch.
Weights keep the JAX package's Keras layout and its ``.npz`` checkpoint
format.

The entry points run on the card unless asked for the CPU:
``load_params``, ``from_numpy_tree`` and ``init_stacked_lstm`` put the
model on ``device="cuda"`` by default (``device="cpu"`` for the CPU), and
``predict``, ``fit`` and ``finetune`` follow the device of their model and
input.

Importing the package has no side effects: it imports neither JAX nor the
JAX package, builds no kernel and changes no global setting.
"""

__version__ = "0.1.0"

from svd_lstm_tpu_torch.api import exact_matmul, model_input_dim, predict, valid_impls
from svd_lstm_tpu_torch.config import DataConfig, FactorConfig, ModelConfig, TrainConfig
from svd_lstm_tpu_torch.factor.svd import (
    factorize_lstm_params,
    make_reduced_model,
    make_singular_model,
    singular_to_dense,
    truncate_singular_layer,
)
from svd_lstm_tpu_torch.io.checkpoint import (
    from_numpy_tree,
    load_params,
    save_params,
    to_numpy_tree,
)
from svd_lstm_tpu_torch.models.lstm import (
    DenseHead,
    LSTMLayer,
    StackedLSTM,
    init_stacked_lstm,
    stacked_lstm_apply,
)
from svd_lstm_tpu_torch.models.reduced import ReducedLayer, ReducedLSTM, reduced_lstm_apply
from svd_lstm_tpu_torch.models.singular import (
    SingularLayer,
    SingularLSTM,
    singular_lstm_apply,
)
from svd_lstm_tpu_torch.ops.cuda_batched import batched_forward_fast
from svd_lstm_tpu_torch.ops.layouts import reconstruct_dense_model
from svd_lstm_tpu_torch.train.finetune import finetune
from svd_lstm_tpu_torch.train.loop import TrainResult, fit
from svd_lstm_tpu_torch.train.metrics import nrmse, rmse, signaltonoise
from svd_lstm_tpu_torch.utils.precision import PRECISION_MODES, cast_params, matmul_scope
