"""Data parallelism over a ``torch.distributed`` process group and the
(data, model) mesh with the coupling nets' tensor parallelism, the port's
counterpart of ``inverse_flow_tpu/parallel``."""

from .data_parallel import (World, all_reduce_mean_, all_reduce_sum_,
                            barrier, broadcast_, init_from_env, rank_seed,
                            replicas_equal, shard_batch, spawn, world)
from .mesh import (Mesh, all_reduce_grads_, apply_shardings, clip_grad_norm_,
                   copy_to_model, coupling_tp_shardings, gather_shard,
                   gather_shardings, is_sharded, make_mesh, make_mesh_2d,
                   mesh_replicas_equal, reduce_from_model)

__all__ = ["World", "all_reduce_mean_", "all_reduce_sum_", "barrier",
           "broadcast_", "init_from_env", "rank_seed", "replicas_equal",
           "shard_batch", "spawn", "world", "Mesh", "all_reduce_grads_",
           "apply_shardings", "clip_grad_norm_", "copy_to_model",
           "coupling_tp_shardings", "gather_shard", "gather_shardings",
           "is_sharded", "make_mesh", "make_mesh_2d", "mesh_replicas_equal",
           "reduce_from_model"]
