from svd_lstm_tpu_torch.factor.prune_magnitude import (
    PolynomialDecaySchedule,
    finetune_with_pruning,
    magnitude_mask,
    prune_sigmas,
    sigma_sparsity,
)
from svd_lstm_tpu_torch.factor.prune_units import prune_to_width, prune_units, unit_importance
from svd_lstm_tpu_torch.factor.regularizers import (
    hoyer_penalty,
    orthogonal_penalty,
    trace_norm_penalty,
)
from svd_lstm_tpu_torch.factor.svd import (
    conv_singular_to_dense,
    factorize_lstm_params,
    get_model_singular_values,
    make_conv_reduced_model,
    make_conv_singular_model,
    make_reduced_model,
    make_singular_model,
    reduce_matrix_rank,
    reduce_two_step,
    set_model_matrix_rank,
    singular_to_dense,
    truncate_singular_layer,
    two_step_factors,
)
