"""Data parallelism over a ``torch.distributed`` process group, the port's
counterpart of ``inverse_flow_tpu/parallel``."""

from .data_parallel import (World, all_reduce_mean_, all_reduce_sum_,
                            barrier, broadcast_, init_from_env, rank_seed,
                            replicas_equal, shard_batch, spawn, world)

__all__ = ["World", "all_reduce_mean_", "all_reduce_sum_", "barrier",
           "broadcast_", "init_from_env", "rank_seed", "replicas_equal",
           "shard_batch", "spawn", "world"]
