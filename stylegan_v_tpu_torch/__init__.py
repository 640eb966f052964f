"""stylegan_v_tpu_torch — the PyTorch/CUDA port of stylegan_v_tpu.

The port grows beside the JAX package, which stays the reference it is held
against. It imports torch and numpy, never jax, flax or stylegan_v_tpu, and
mirrors the JAX package's subpackages (ops/, models/, io/, utils/).

  * Activations are NCHW, conv weights OIHW, FC weights [out, in], with the
    original StyleGAN-V state_dict names.
  * Weights are drawn from an explicit torch.Generator, never the global RNG;
    modules are moved to a device explicitly.
  * Plain tensor code is eager PyTorch. Each TPU kernel of the JAX package
    becomes a kernel written by hand for Hopper (CUDA C++ under csrc/), with
    its plain PyTorch version beside it for CPU tensors.
"""

__version__ = "0.1.0"
