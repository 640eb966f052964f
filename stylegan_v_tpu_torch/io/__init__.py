from .bridge import jax_to_torch_discriminator, jax_to_torch_generator  # noqa: F401
