from litepi_tpu_torch.weights.fold_bn import (
    fold_batchnorm,
    fold_pipeline_state,
    fold_stem_input,
    stem_kernel_hwio,
)
from litepi_tpu_torch.weights.jax_bridge import jax_to_state_dict, state_dict_to_jax

__all__ = [
    "fold_batchnorm",
    "fold_pipeline_state",
    "fold_stem_input",
    "jax_to_state_dict",
    "state_dict_to_jax",
    "stem_kernel_hwio",
]
