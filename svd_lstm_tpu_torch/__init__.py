"""svd_lstm_tpu_torch — the PyTorch + CUDA port of ``svd_lstm_tpu``.

On an NVIDIA H100: train a stacked-LSTM regressor (``fit``), factorize it
(U·Σ·Vᵀ), fine-tune σ under the Hoyer penalty (``finetune``), truncate to
the exact two-step form ``(x·B)·[I|C]``, recover the truncated model's
accuracy by training its factors (``finetune_reduced``, the gated
``recover_reduced_gated`` and ``truncate_recover_progressive``), and
predict with the dense or the reduced model at batch 1 or batched
(``precision="exact"``, ``"high"`` or ``"fast"``), and deploy it: int8
quantization (``quantize_params``, the QAT view ``qat_apply``), the per-gate
and two-step CSV exports and the int8 ``.bin`` (``io/``), the native C++
runtime (``io.native.NativeModel``), frame-at-a-time streaming
(``make_stream_fn``, a CUDA graph a frame on the card) and the ``export`` /
``stream`` commands (``python -m svd_lstm_tpu_torch``). The batch-1 recurrences (exact and bf16-operand), the batched fast-mode
recurrence and the training recurrences (forward and backward) run in
hand-written CUDA kernels (``ops/csrc``); everything else is plain PyTorch.
Weights keep the JAX package's Keras layout and its ``.npz`` checkpoint
format. Every step above also takes the Conv1D + LSTM hybrids
(``init_conv_lstm``, ``models/conv.py``): their conv front end runs first,
then the stack's own route. Fine-tunes take Keras-semantics dropout
(``FactorConfig.dropout``, ``recurrent_dropout``) and the plain scan takes
chunked-time rematerialization (``TrainConfig.remat_chunk``); the
structural surgery prunes whole units (``prune_to_width``), prunes σ by
magnitude while fine-tuning (``finetune_with_pruning``) and merges two
parallel cells into one layer (``merge_parallel_cell_weights``). The JAX
package's workflow scripts are modules of ``examples/`` and commands of
``python -m svd_lstm_tpu_torch`` (``train``, ``compress``, ``sweep``,
``rank-rmse``, ``timing``, ``freq``, ``batched``, ``seq-train``,
``native-bench``, ``distributed``), their figures in ``viz/plots.py``.
Multi-rank execution over ``torch.distributed`` is ``parallel/``: the
data-parallel loops, the gate-column tensor-parallel step, sharded batched
inference and the pipeline-parallel whole-run inference, SPMD (every rank
calls the same function); ``entry.entry()`` gives the 4x40 forward step
and its example arguments.

The entry points run on the card unless asked for the CPU:
``load_params``, ``from_numpy_tree``, ``init_stacked_lstm`` and
``init_conv_lstm`` put the model on ``device="cuda"`` by default (``device="cpu"`` for the CPU), and
``predict``, ``fit``, ``finetune`` and the recovery functions follow the
device of their model and input.

Importing the package has no side effects: it imports neither JAX nor the
JAX package, builds no kernel and changes no global setting.
"""

__version__ = "0.1.0"

from svd_lstm_tpu_torch.api import exact_matmul, model_input_dim, predict, valid_impls
from svd_lstm_tpu_torch.config import DataConfig, FactorConfig, ModelConfig, TrainConfig
from svd_lstm_tpu_torch.factor.svd import (
    conv_singular_to_dense,
    factorize_lstm_params,
    make_conv_reduced_model,
    make_conv_singular_model,
    make_reduced_model,
    make_singular_model,
    singular_to_dense,
    truncate_singular_layer,
)
from svd_lstm_tpu_torch.factor.prune_magnitude import (
    PolynomialDecaySchedule,
    finetune_with_pruning,
    magnitude_mask,
    prune_sigmas,
    sigma_sparsity,
)
from svd_lstm_tpu_torch.factor.prune_units import prune_to_width, prune_units, unit_importance
from svd_lstm_tpu_torch.io.checkpoint import (
    from_numpy_tree,
    load_params,
    save_params,
    to_numpy_tree,
)
from svd_lstm_tpu_torch.models.conv import (
    ConvFront,
    ConvLSTM,
    ConvReducedLSTM,
    ConvSingularLSTM,
    conv_lstm_apply,
    conv_reduced_apply,
    conv_singular_apply,
    init_conv_lstm,
)
from svd_lstm_tpu_torch.models.lstm import (
    DenseHead,
    LSTMLayer,
    StackedLSTM,
    init_stacked_lstm,
    lstm_layer_apply,
    stacked_lstm_apply,
)
from svd_lstm_tpu_torch.models.merge import merge_parallel_cell_weights
from svd_lstm_tpu_torch.models.reduced import ReducedLayer, ReducedLSTM, reduced_lstm_apply
from svd_lstm_tpu_torch.models.singular import (
    SingularLayer,
    SingularLSTM,
    singular_lstm_apply,
)
from svd_lstm_tpu_torch.models.streaming import (
    init_stream,
    make_stream_fn,
    stream_many,
    stream_step,
)
from svd_lstm_tpu_torch.ops.cuda_batched import batched_forward_fast
from svd_lstm_tpu_torch.ops.layouts import reconstruct_dense_model
from svd_lstm_tpu_torch.train.finetune import (
    dropout_apply_fn,
    finetune,
    finetune_reduced,
    harvest_sigmas,
    recover_reduced_gated,
    truncate_recover_progressive,
)
from svd_lstm_tpu_torch.train.loop import TrainResult, fit, predict_full_run
from svd_lstm_tpu_torch.train.metrics import nrmse, rmse, signaltonoise
from svd_lstm_tpu_torch.utils.precision import PRECISION_MODES, cast_params, matmul_scope
from svd_lstm_tpu_torch.utils.quantize import (
    QuantizedTensor,
    dequantize_params,
    fake_quantize_params,
    param_bytes,
    qat_apply,
    quantize_params,
    quantized_apply,
)
