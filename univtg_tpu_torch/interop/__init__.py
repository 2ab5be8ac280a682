from univtg_tpu_torch.interop.jax_params import (  # noqa: F401
    load_torch_checkpoint,
    md_state_dict_from_jax_params,
    read_checkpoint,
    state_dict_from_jax,
    state_dict_from_jax_params,
)
from univtg_tpu_torch.interop.torch_ckpt import (  # noqa: F401
    config_from_reference_opt,
    load_reference_run,
)
