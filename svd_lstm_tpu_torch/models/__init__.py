from svd_lstm_tpu_torch.models.lstm import DenseHead, LSTMLayer, StackedLSTM
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
    "init_stream",
    "make_stream_fn",
    "stream_many",
    "stream_step",
]
