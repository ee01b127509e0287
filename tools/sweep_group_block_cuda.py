"""Time the group kernel at several block geometries, on one GPU.

The counterpart of ``tools/sweep_group_block.py`` for ``crafter_tpu_torch``.
The JAX tool sweeps the Pallas kernel's ``block`` (envs a grid step); the
CUDA kernel runs one env a block, so its counterpart is the block's
geometry: threads a block and ``__launch_bounds__``' minimum resident blocks
an SM, both compile-time constants of ``csrc/group_tick.cu``.  Each
variant ``threads:min_blocks`` is a build of its own
(``_build.library(geometry=...)``, every variant's ``nvcc`` started
together); ``256:5`` is the shipped build.

As the JAX tool: ``N`` envs of ``EnvConfig(reward=False)`` from
``vec_reset_chunked(home_keys(0, N))``, GROUPS groups of K ticks a loop,
each group's actions drawn from a key (``key, k_act = split(key)``,
``randint(k_act, (K, N), 0, 17)``), one warm-up loop from the reset state
with key 0, then three loops with keys 1-3, each from the last one's
states, every env's step required to advance by GROUPS * K; best of 3.
A loop's actions are drawn before its clock starts: the draws are eager
PyTorch, ~5 ms of the host's time a group against the kernel's ~0.9 ms,
where the JAX tool's scan fuses them beside its kernel.  So the loop times
the kernel launches alone (CUDA events), as the JAX line's "kernel-only
loop" says.
Every variant runs from the same states with the same keys, so its final
states, last ``raw`` and ``occ`` must equal the shipped build's bit for
bit (a geometry changes no result), or the tool stops.

Prints the JAX tool's line with the geometry in place of the block, then
the variant's registers and spills (its ``ptxas.log``) and its blocks an
SM (the occupancy calculator), and the card's name and power limit.
``main(argv)`` returns the record.

    python tools/sweep_group_block_cuda.py [N] [threads:min_blocks ...]
    python tools/sweep_group_block_cuda.py 8 --groups 2 --device cpu

``--device cpu`` times the plain group step once, under the label
``plain``, and takes no geometry.  Without a GPU the default run stops
with an error.
"""

import pathlib as _pathlib
import sys as _sys

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402
import time  # noqa: E402

GROUPS = 40
VARIANTS = ('128:5', '256:5', '256:4', '512:4')


def parse_geometry(text: str) -> tuple[int, int]:
  """``'threads:min_blocks'`` -> checked ``(threads, min_blocks)``."""
  from crafter_tpu_torch import _build
  try:
    threads, min_blocks = (int(v) for v in text.split(':'))
  except ValueError:
    raise ValueError(f'{text!r}: want threads:min_blocks') from None
  _build.check_geometry((threads, min_blocks))
  return threads, min_blocks


def draw_actions(key, kk: int, n: int, groups: int):
  """``(key, actions)``: the JAX tool's draws for ``groups`` groups in
  turn, as (groups, K, N) int32 (one ``randint`` over the groups' keys,
  which draws each key's bits as its own call would)."""
  import torch
  from crafter_tpu_torch import prng
  k_acts = []
  for _ in range(groups):
    key, k_act = prng.split(key, 2)
    k_acts.append(k_act)
  return key, prng.randint(torch.stack(k_acts), 0, 17, (kk, n))


def loop(env, actions, cfg, geometry=None):
  """A group step for each group's (K, N) actions: ``(env, raw, occ,
  done count)`` after the last."""
  from crafter_tpu_torch import step_cuda
  done = 0
  for acts in actions:
    env, raw, occ = step_cuda.group_tick(env, acts, cfg, geometry=geometry)
    done = done + raw.done.sum()
  return env, raw, occ, done


def _same(a, b) -> bool:
  """Equal leaf for leaf: states, step outputs or tensors."""
  from crafter_tpu_torch.state import leaves
  return all(x.equal(y) for (_, x), (_, y) in zip(leaves(a), leaves(b)))


def _usage(geometry):
  """Registers and spill bytes of the group kernel's 64-high instantiation
  in the build of ``geometry``."""
  from crafter_tpu_torch import _build
  usage = _build.ptxas_usage(geometry)
  name = next(k for k in usage
              if 'group_tick_kernel' in k and 'ILi64E' in k)
  return usage[name]


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('n', type=int, nargs='?', default=4096)
  parser.add_argument('variants', nargs='*',
                      help='threads:min_blocks (default: '
                      + ' '.join(VARIANTS) + ')')
  parser.add_argument('--groups', type=int, default=GROUPS)
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  from crafter_tpu_torch.utils import tool_device
  dev, card = tool_device(args.device, 'sweep_group_block_cuda')
  import torch
  import crafter_tpu_torch as ct
  from crafter_tpu_torch import _build, prng, step_cuda

  n, groups = args.n, args.groups
  cuda = dev.type == 'cuda'
  if not cuda and args.variants:
    raise SystemExit('sweep_group_block_cuda: a geometry is a build of the '
                     'CUDA kernel; --device cpu times the plain group step')
  # The shipped build (None) runs first: every variant is held against it.
  geometries = [None]
  if cuda:
    geometries += [g for g in map(parse_geometry, args.variants or VARIANTS)
                   if _build.check_geometry(g) is not None]
  cfg = ct.EnvConfig(reward=False)
  kk = cfg.balance_every
  ticks = groups * kk
  start = ct.vec_reset_chunked(ct.home_keys(0, n, dev), cfg).env
  if cuda:
    t0 = time.perf_counter()
    _build.build_many(geometries)
    print(f'built {len(geometries)} geometries in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)

  def sync():
    if cuda:
      torch.cuda.synchronize(dev)

  def timed_loop(env, seed, geometry):
    actions = draw_actions(prng.key(seed, dev), kk, n, groups)[1]
    sync()
    if cuda:
      ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
      ev[0].record()
      out = loop(env, actions, cfg, geometry)
      ev[1].record()
      sync()
      return out, ev[0].elapsed_time(ev[1]) / 1e3
    t0 = time.perf_counter()
    out = loop(env, actions, cfg, geometry)
    int(out[3])
    return out, time.perf_counter() - t0

  ref, rec = None, {'n': n, 'groups': groups, 'ticks': ticks,
                    'device': str(dev), 'card': card, 'variants': {}}
  for geometry in geometries:
    threads, min_blocks = geometry or _build.DEFAULT_GEOMETRY
    label = f'{threads}:{min_blocks}' if cuda else 'plain'
    env = start
    reps = 3 if cuda else 1
    if cuda:                            # warm-up from the reset state
      env = timed_loop(env, 0, geometry)[0][0]
    best = float('inf')
    for r in range(reps):
      (env2, raw, occ, _), seconds = timed_loop(env, r + 1, geometry)
      if not bool((env2.step - env.step == ticks).all()):
        raise SystemExit(f'sweep_group_block_cuda: {label}: not every env '
                         f'advanced by {ticks} steps')
      best = min(best, seconds)
      env = env2
    per_tick = best / ticks * 1e3
    name = (f'threads={threads} min_blocks={min_blocks}' if cuda
            else 'plain')
    print(f'{name}: {per_tick:.3f} ms/tick ({n * ticks / best / 1e3:,.0f}k '
          'steps/s kernel-only loop)', flush=True)
    entry = {'ms_per_tick': per_tick, 'seconds': best}
    if cuda:
      final = (env, raw, occ)
      if ref is None:
        ref = final
      elif not all(map(_same, final, ref)):
        raise SystemExit(f'sweep_group_block_cuda: {label} differs from the '
                         'shipped build')
      usage = _usage(geometry)
      blocks, smem = step_cuda.occupancy(cfg, 'group', geometry=geometry)
      entry.update(usage, blocks_per_sm=blocks, smem=smem)
      print(f'  {label}: {usage["registers"]} registers, '
            f'{usage["spill_stores"]} B spill stores, {usage["spill_loads"]} '
            f'B spill loads; {blocks} blocks of {threads} threads an SM, '
            f'{smem} B shared a block; states, raw and occ equal to the '
            'shipped build\'s', flush=True)
    rec['variants'][label] = entry
  if card:
    print(card, flush=True)
  return rec


if __name__ == '__main__':
  main()
