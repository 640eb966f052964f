from .bridge import (  # noqa: F401
    jax_to_torch_adam,
    jax_to_torch_c3d,
    jax_to_torch_discriminator,
    jax_to_torch_generator,
    jax_to_torch_i3d,
    jax_to_torch_inception,
    jax_to_torch_train_state,
)
from .checkpoint import (  # noqa: F401
    copy_params,
    find_latest_snapshot,
    load_adam_state,
    load_snapshot,
    meta_decode,
    restore_train_state,
    save_snapshot,
)
