"""svd_lstm_tpu_torch — the PyTorch + CUDA port of ``svd_lstm_tpu``.

Batch-1 compress-and-predict on an NVIDIA H100: load a checkpoint, predict
with the dense model, factorize (U·Σ·Vᵀ), truncate to the exact two-step
form ``(x·B)·[I|C]``, predict with the reduced model. The batch-1
recurrences run in hand-written CUDA kernels (``ops/csrc``); everything
else is plain PyTorch. Weights keep the JAX package's Keras layout and its
``.npz`` checkpoint format.

Importing the package has no side effects: it imports neither JAX nor the
JAX package, builds no kernel and changes no global setting.
"""

__version__ = "0.1.0"

from svd_lstm_tpu_torch.api import model_input_dim, predict, valid_impls
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
    stacked_lstm_apply,
)
from svd_lstm_tpu_torch.models.reduced import ReducedLayer, ReducedLSTM, reduced_lstm_apply
from svd_lstm_tpu_torch.models.singular import (
    SingularLayer,
    SingularLSTM,
    singular_lstm_apply,
)
from svd_lstm_tpu_torch.ops.layouts import reconstruct_dense_model
from svd_lstm_tpu_torch.train.metrics import nrmse, rmse, signaltonoise
