"""Process groups and sharding helpers for the env batch.

The port's counterpart of ``crafter_tpu/parallel/mesh.py``.  A
:class:`Mesh` is one data-parallel axis: ``size`` ranks of a
``torch.distributed`` process group, one process a device, rank ``r``
holding the contiguous rows ``[r*n/W, (r+1)*n/W)`` of an ``n``-env batch on
its own device.  Without an initialised process group the mesh has one rank
and no collective runs, as the JAX package's mesh of one device.

Collectives are SUM all-reduces and broadcasts only: gloo offers no more on
CUDA tensors, and several ranks sharing one card must use gloo (NCCL
refuses two ranks on one GPU).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
  """This process's place on a 1-D data-parallel mesh.

  ``group`` is the process group (None for a mesh of one rank without
  one), ``rank`` and ``size`` this rank and the rank count, ``device`` the
  device this rank holds its rows on.
  """

  group: Optional[Any]
  rank: int
  size: int
  device: torch.device

  def rows(self, n: int) -> slice:
    """This rank's rows of an ``n``-row batch; raises unless the ranks
    divide ``n``, as a ``P('dp')`` sharding does."""
    if n % self.size:
      raise ValueError(f'a batch of {n} does not split over {self.size} '
                       'ranks')
    m = n // self.size
    return slice(self.rank * m, (self.rank + 1) * m)


def _cuda_or_raise(device: torch.device, what: str) -> None:
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(f'{what}: device cuda asked for, but '
                       'torch.cuda.is_available() is false')


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device='cuda') -> None:
  """Join this process to the group of ``num_processes`` ranks.

  ``coordinator`` is ``host:port`` of rank 0's TCP store; without it the
  group comes from torchrun's environment (``env://``: ``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  The backend defaults to
  ``nccl`` on ``cuda`` and ``gloo`` on ``cpu``; several ranks on one card
  need ``backend='gloo'``.  On ``cuda`` the rank binds device
  ``LOCAL_RANK``, else ``rank % device_count``.  A failure raises: no other
  backend or device is tried.
  """
  device = torch.device(device)
  _cuda_or_raise(device, 'distributed_init')
  backend = backend or ('nccl' if device.type == 'cuda' else 'gloo')
  if coordinator is None:
    rank = int(os.environ['RANK'])
    kwargs = dict(init_method='env://')
  else:
    rank = process_id
    kwargs = dict(init_method=f'tcp://{coordinator}',
                  world_size=num_processes, rank=process_id)
  if device.type == 'cuda':
    local = torch.device('cuda', int(os.environ.get(
        'LOCAL_RANK', rank % torch.cuda.device_count())))
    torch.cuda.set_device(local)
    if backend == 'nccl':
      kwargs['device_id'] = local    # the communicator's device, bound now
  dist.init_process_group(backend, **kwargs)


def dp_mesh(n_devices: Optional[int] = None, device='cuda') -> Mesh:
  """The mesh over every rank of the initialised process group (the
  ``n_devices`` given must be their count), or a mesh of one rank without
  a group.  On ``cuda`` the rank's device is the current CUDA device."""
  device = torch.device(device)
  _cuda_or_raise(device, 'dp_mesh')
  if device.type == 'cuda':
    device = torch.device('cuda', torch.cuda.current_device())
  if not dist.is_initialized():
    if n_devices not in (None, 1):
      raise ValueError(f'a mesh of {n_devices} devices needs an initialised '
                       'process group (distributed_init)')
    return Mesh(None, 0, 1, device)
  size = dist.get_world_size()
  if n_devices not in (None, size):
    raise ValueError(f'the process group has {size} ranks, not {n_devices}')
  return Mesh(dist.group.WORLD, dist.get_rank(), size, device)


def _map(fn, tree):
  """``fn`` on every leaf of nested dataclasses, dicts, tuples and lists."""
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    return dataclasses.replace(tree, **{
        f.name: _map(fn, getattr(tree, f.name))
        for f in dataclasses.fields(tree) if f.init})
  if isinstance(tree, dict):
    return {name: _map(fn, v) for name, v in tree.items()}
  if isinstance(tree, tuple) and hasattr(tree, '_fields'):
    return type(tree)(*(_map(fn, v) for v in tree))
  if isinstance(tree, (tuple, list)):
    return type(tree)(_map(fn, v) for v in tree)
  return fn(tree)


def _bytes(t: torch.Tensor) -> torch.Tensor:
  """A contiguous tensor's storage as uint8, for collectives that move
  every dtype (bool included) alike."""
  return t.reshape(-1).view(torch.uint8)


def shard_batch(tree, mesh: Mesh, batch_size: int):
  """This rank's rows of every tensor whose leading axis is the env batch
  (``batch_size``), copied to the mesh's device; other tensors are moved
  there whole, as the same value on every rank.  0-d tensors stay where
  they are (the port keeps its counters, such as ``VecState.tick``, on the
  host), and leaves that are no tensors (a policy, an optimizer, Python
  numbers) are returned as they are."""
  rows = mesh.rows(batch_size)

  def place(leaf):
    if not isinstance(leaf, torch.Tensor) or leaf.ndim == 0:
      return leaf
    if leaf.shape[0] == batch_size:
      leaf = leaf[rows]
    return leaf.to(mesh.device, copy=True)

  return _map(place, tree)


def replicate(tree, mesh: Mesh):
  """Every tensor of ``tree`` as rank 0 holds it, on the mesh's device of
  every rank (a broadcast from rank 0)."""
  def bcast(leaf):
    if not isinstance(leaf, torch.Tensor):
      return leaf
    out = leaf.detach().to(mesh.device, copy=True).contiguous()
    if mesh.group is not None:
      dist.broadcast(_bytes(out), src=0, group=mesh.group)
    return out

  return _map(bcast, tree)


def psum_stats(tree, mesh: Mesh):
  """Every leaf summed over the ranks, on every rank (a SUM all-reduce).

  Leaves of rank >= 1 are summed elementwise across ranks (each rank's
  rows against the others'); 0-d tensors and Python numbers are per-process
  partial sums, so the result is their sum over processes.  Booleans are
  counted as int64; Python numbers become tensors of their type.
  """
  def reduce(leaf):
    t = torch.as_tensor(leaf).detach().to(mesh.device, copy=True)
    if t.dtype == torch.bool:
      t = t.to(torch.int64)
    if mesh.group is not None:
      dist.all_reduce(t, group=mesh.group)
    return t

  return _map(reduce, tree)


def gather_batch(tree, mesh: Mesh, batch_size: int, axis: int = 0):
  """The whole batch from every rank's rows, on every rank: each tensor
  whose ``axis`` holds this rank's ``batch_size / W`` rows comes back with
  all ``batch_size`` rows; other leaves are returned as they are.

  The counterpart of reading a sharded ``jax.Array`` on the host, for
  tests and tools.  Each rank writes its rows into zeros of the global
  shape and one SUM all-reduce of the bytes adds the ranks' parts: exact
  for every dtype, since one rank writes each byte.
  """
  rows = mesh.rows(batch_size)
  m = rows.stop - rows.start

  def gather(leaf):
    if (not isinstance(leaf, torch.Tensor) or leaf.ndim <= axis
        or leaf.shape[axis] != m):
      return leaf
    shape = list(leaf.shape)
    shape[axis] = batch_size
    out = torch.zeros(shape, dtype=leaf.dtype, device=mesh.device)
    out.narrow(axis, rows.start, m).copy_(leaf)
    if mesh.group is not None:
      dist.all_reduce(_bytes(out), group=mesh.group)
    return out

  return _map(gather, tree)


def make_sharded_group_step(mesh: Mesh, cfg, reset_batch: int):
  """The multi-device engine step: each rank advances its own rows of a
  sharded ``VecState`` one balance-cadence group per call, through the
  unmodified :func:`crafter_tpu_torch.env.vec_step_group`.

  Env rows are independent, so no collective runs.  The reset pass is per
  rank with ``ceil(reset_batch / W)`` slots, as the JAX package's per-shard
  pass (``crafter_tpu/parallel/mesh.py:make_sharded_group_step``): when no
  rank overflows its slots, the same envs reset with the same worlds as in
  the one-process pass; when deaths cluster on one rank, its overflow envs
  wait one group more though another rank had free slots (a latency, not a
  correctness, difference).

  Returns ``step(vs, actions) -> (vs, outs)`` for this rank's ``(K,
  n_local)`` actions.
  """
  from ..env import vec_step_group

  rb_local = max(1, -(-reset_batch // mesh.size))

  def step(vs, actions):
    return vec_step_group(vs, actions, cfg, rb_local)

  return step
