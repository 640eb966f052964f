from .bridge import (  # noqa: F401
    jax_to_torch_discriminator,
    jax_to_torch_generator,
    jax_to_torch_train_state,
)
