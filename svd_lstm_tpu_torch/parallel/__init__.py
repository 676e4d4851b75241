"""Multi-rank execution over ``torch.distributed``: the (dp, tp) mesh and its
launcher, the sharded train steps and batched inference, the data-parallel
training loops and the pipeline-parallel whole-run inference. Counterpart of
``svd_lstm_tpu/parallel/``."""

from svd_lstm_tpu_torch.parallel.fit import finetune_dp, finetune_reduced_dp, fit_dp
from svd_lstm_tpu_torch.parallel.mesh import Mesh, launch, make_mesh, process_group
from svd_lstm_tpu_torch.parallel.pipeline import make_pipeline_inference
from svd_lstm_tpu_torch.parallel.train import (
    make_batched_fast_inference,
    make_batched_inference,
    make_dp_finetune_step,
    make_dp_train_step,
    make_sharded_train_step,
    shard_layer_tp,
    shard_params_for_mesh,
    unshard_params_from_mesh,
)
