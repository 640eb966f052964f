"""Data-parallel training over processes (the counterpart of
stylegan_v_tpu/parallel/): the process group, the batch rows and draws of a
rank, the step's collectives and the launcher (`distributed`), and ZeRO-1
(`zero`)."""
from .distributed import (RowPlan, RowsDraws, World, all_reduce_mean_, all_reduce_sum,
                          broadcast_module_, broadcast_tensors_, default_backend,
                          destroy_distributed, init_distributed, launch, mbstd_group,
                          rank_draws, rank_rows, row_plan, world)
from .zero import consolidate_optimizers_, is_zero, make_adam, opt_state_bytes_per_device

__all__ = ["RowPlan", "RowsDraws", "World", "all_reduce_mean_", "all_reduce_sum",
           "broadcast_module_", "broadcast_tensors_", "consolidate_optimizers_",
           "default_backend", "destroy_distributed", "init_distributed", "is_zero", "launch",
           "make_adam", "mbstd_group", "opt_state_bytes_per_device", "rank_draws",
           "rank_rows", "row_plan", "world"]
