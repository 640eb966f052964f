"""The benchmark of stylegan_v_tpu_torch on NVIDIA GPUs (README.md)."""
