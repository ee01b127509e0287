"""Data parallelism over processes: one rank a device.

The port's counterpart of ``crafter_tpu/parallel``.  The JAX package runs
one process over many devices and shards with ``shard_map`` and GSPMD; here
each device is a process of a ``torch.distributed`` group, so every global
quantity the JAX package reads implicitly is an explicit collective:
``psum_stats`` and ``gather_batch`` are SUM all-reduces, the reset budget
of the sharded ``VecEnv`` and training is one all-reduce of per-rank
counts a pass, and the learner all-reduces its gradients
(``crafter_tpu_torch/ppo.py:make_sharded_train``).
"""

from .mesh import (Mesh, distributed_init, dp_mesh, gather_batch,
                   make_sharded_group_step, psum_stats, replicate,
                   shard_batch)
