from svd_lstm_tpu_torch.models.lstm import DenseHead, LSTMLayer, StackedLSTM
from svd_lstm_tpu_torch.models.reduced import ReducedLayer, ReducedLSTM
from svd_lstm_tpu_torch.models.singular import SingularLayer, SingularLSTM

__all__ = [
    "DenseHead",
    "LSTMLayer",
    "StackedLSTM",
    "SingularLayer",
    "SingularLSTM",
    "ReducedLayer",
    "ReducedLSTM",
]
