"""The mesh, sharding rules and collectives over torch.distributed."""

from .mesh import Mesh, make_mesh
from .sharding import (param_shardings, index_shardings, shard_pytree,
                       batch_shardings, train_state_shardings, local_block)
from .collectives import (all_reduce_grads, all_reduce_sum, sharded_embedding,
                          sharded_gather, whole_leaf)

__all__ = ["Mesh", "make_mesh", "param_shardings", "index_shardings",
           "shard_pytree", "batch_shardings", "train_state_shardings",
           "local_block", "whole_leaf", "sharded_gather", "all_reduce_sum",
           "all_reduce_grads", "sharded_embedding"]
