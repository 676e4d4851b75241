"""DROPBEAR data pipeline of the port: numpy only, no JAX."""

from svd_lstm_tpu_torch.data.batcher import split_train_random, window_epoch_iterator
from svd_lstm_tpu_torch.data.dropbear import Dataset, RawRun, load_dropbear_json, preprocess, preprocess_raw
from svd_lstm_tpu_torch.data.scalers import StandardScaler
from svd_lstm_tpu_torch.data.synthetic import generate_time_series, synthetic_dropbear_raw
