from svd_lstm_tpu_torch.models.conv import ConvFront, ConvLSTM, ConvReducedLSTM, ConvSingularLSTM
from svd_lstm_tpu_torch.models.lstm import DenseHead, LSTMLayer, StackedLSTM
from svd_lstm_tpu_torch.models.merge import merge_parallel_cell_weights
from svd_lstm_tpu_torch.models.reduced import ReducedLayer, ReducedLSTM
from svd_lstm_tpu_torch.models.singular import SingularLayer, SingularLSTM
from svd_lstm_tpu_torch.models.streaming import (
    init_stream,
    make_stream_fn,
    stream_many,
    stream_step,
)

__all__ = [
    "DenseHead",
    "LSTMLayer",
    "StackedLSTM",
    "SingularLayer",
    "SingularLSTM",
    "ReducedLayer",
    "ReducedLSTM",
    "ConvFront",
    "ConvLSTM",
    "ConvSingularLSTM",
    "ConvReducedLSTM",
    "merge_parallel_cell_weights",
    "init_stream",
    "make_stream_fn",
    "stream_many",
    "stream_step",
]
