"""Micro-bench: the threefry kernel (``csrc/threefry.cu``) on the draws of a
reset pass, on one GPU.

A reset pass of R worlds makes nine threefry draws (``env._reset_pass``
and ``worldgen.generate_world``): ``fold_in`` of the worlds' keys, two
``split(keys, 3)``, ``randint``'s split and two bit draws, the material and
object ``uniform`` planes of (4, W, H) and (3, W, H) a world, and the
state's ``fold_in(keys, 0x5eed)``.  For each world count the tool checks
the kernel's planes against the int64 twin (``prng.threefry2x32`` on the
same device) and prints, per pass:

* ``kernel_ms``: the kernel alone, the mean device time of each of its
  launches in a ``torch.profiler`` trace times its launches a pass (the
  profiler loses some records);
* ``wrapper_ms``: the nine calls between CUDA events, median of ``--reps``;
* ``twin_ms``: the twin's int64 rounds for the same draws on the same
  device, median of ``--reps``;
* ``bound_ms``: the larger of the pass's 32-bit integer operations
  (``OPS_PER_DRAW`` a draw) over the card's integer issue rate and its
  bytes (keys read, outputs written, once each) over 3.35 TB/s.

Then each output mode's registers (``ptxas``) and resident blocks an SM,
and the card's name and power limit.  ``main(argv)`` returns the record.

    python tools/bench_threefry_cuda.py [--worlds 320 5120] [--reps 20]
    python tools/bench_threefry_cuda.py --device cpu --worlds 2 --reps 1

``--device cpu`` runs the twin alone (no kernel figures); without a GPU the
default run stops with an error.
"""

import pathlib as _pathlib
import sys as _sys

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402
import statistics  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

AREA = (64, 64)
# The threefry block as sm_90 issues it: the third key word (one
# three-input xor), the first injection (one add: x0 = 0 + k0 is a move),
# 20 rounds of add, funnel shift and xor, and five injections of two adds
# (ks + (i + 1) folds into a three-input add); the output's xor and, for a
# uniform, its shift and or (the float subtraction is not an integer op).
OPS_PER_DRAW = 1 + 1 + 20 * 3 + 5 * 2 + 3
# H100 SXM: 132 SMs, 64 lanes of 32-bit integer arithmetic an SM a clock,
# 1.98 GHz boost clock (NVIDIA's Hopper architecture white paper).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12


def pass_draws(keys: torch.Tensor, area=AREA):
  """The nine draws of a reset pass of ``keys`` (R, 2), as the pass and
  worldgen make them; returns the two uniform planes."""
  from crafter_tpu_torch import prng
  w, h = area
  r = keys.shape[0]
  keys = prng.fold_in(keys, torch.arange(r, dtype=torch.int32,
                                         device=keys.device))
  sub = prng.split(keys, 3)
  prng.randint(prng.split(keys, 3)[:, 0], 0, 2 ** 31 - 1)
  mat = prng.uniform(sub[:, 1], (4, w, h))
  obj = prng.uniform(sub[:, 2], (3, w, h))
  prng.fold_in(keys, 0x5eed)
  return mat, obj


def pass_work(r: int, area=AREA) -> tuple[int, int]:
  """``(draws, bytes)`` of a pass of ``r`` worlds: a key pair or an output
  word is one draw; the keys (16 bytes) and fold_in's int32 data are read
  once a launch, every output written once."""
  w, h = area
  draws = r * (2 + 2 * 3 + 2 + 2 + 7 * w * h)
  written = r * (2 * 16 + 2 * 3 * 16 + 2 * 16 + 2 * 8 + 7 * w * h * 4)
  read = r * (9 * 16 + 4)
  return draws, written + read


def _twin_block(keys: torch.Tensor, n: int):
  """The int64 twin's rounds for ``n`` counters a key of ``keys``."""
  from crafter_tpu_torch import prng
  i = torch.arange(n, dtype=torch.int64, device=keys.device)
  return prng.threefry2x32(keys[..., None, 0], keys[..., None, 1],
                           torch.zeros_like(i), i)


def twin_pass(keys: torch.Tensor, area=AREA):
  """The twin's rounds for the draws of :func:`pass_draws`, one block a
  draw with its counter count."""
  w, h = area
  for n in (1, 3, 3, 2, 1, 1, 4 * w * h, 3 * w * h, 1):
    _twin_block(keys, n)


def _median_ms(fn, reps, dev):
  fn()
  times = []
  for _ in range(reps):
    if dev.type == 'cuda':
      start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
      start.record()
      fn()
      end.record()
      torch.cuda.synchronize(dev)
      times.append(start.elapsed_time(end))
    else:
      t0 = time.perf_counter()
      fn()
      times.append((time.perf_counter() - t0) * 1e3)
  return statistics.median(times)


def kernel_ms(keys: torch.Tensor, passes: int) -> float:
  """Device ms of the kernel's launches a pass: each launch's mean device
  time in a profiler trace of ``passes`` passes times its launches."""
  from crafter_tpu_torch import prng_cuda
  before = prng_cuda.draw.launches
  with torch.profiler.profile(activities=[
      torch.profiler.ProfilerActivity.CUDA]) as prof:
    for _ in range(passes):
      pass_draws(keys)
    torch.cuda.synchronize()
  launches = prng_cuda.draw.launches - before
  events = [e for e in prof.key_averages() if 'threefry_kernel' in e.key]
  recorded = sum(e.count for e in events)
  if not recorded:
    raise SystemExit('bench_threefry_cuda: the profiler recorded no launch '
                     'of the threefry kernel')
  device_us = sum(e.self_device_time_total for e in events)
  return device_us / 1e3 / recorded * launches / passes


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--worlds', type=int, nargs='+', default=[320, 5120])
  parser.add_argument('--reps', type=int, default=20)
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  from crafter_tpu_torch import _build, prng, prng_cuda
  from crafter_tpu_torch.utils import tool_device
  dev, card = tool_device(args.device, 'bench_threefry_cuda')
  cuda = dev.type == 'cuda'
  rec = {'device': str(dev), 'card': card, 'ops_per_draw': OPS_PER_DRAW,
         'worlds': {}}
  for r in args.worlds:
    keys = prng.fold_in(prng.key(0, dev)[None].expand(r, 2),
                        torch.arange(r, device=dev))
    mat, obj = pass_draws(keys)
    sub = prng.split(prng.fold_in(keys, torch.arange(
        r, dtype=torch.int32, device=dev)), 3)
    for plane, got in ((1, mat), (2, obj)):
      b0, b1 = _twin_block(sub[:, plane], got[0].numel())
      want = (((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32).view(
          torch.float32) - 1.0
      if not torch.equal(got.reshape(want.shape), want):
        raise SystemExit(f'bench_threefry_cuda: plane {plane} of {r} worlds '
                         'differs from the twin')
    draws, nbytes = pass_work(r)
    row = {'draws': draws, 'bytes': nbytes,
           'wrapper_ms': _median_ms(lambda: pass_draws(keys), args.reps, dev),
           'twin_ms': _median_ms(lambda: twin_pass(keys), args.reps, dev)}
    if cuda:
      ops_ms = draws * OPS_PER_DRAW / INT32_OPS_PER_S * 1e3
      bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
      row.update(kernel_ms=kernel_ms(keys, args.reps),
                 bound_ms=max(ops_ms, bytes_ms),
                 bound_by='operations' if ops_ms >= bytes_ms else 'bytes')
    rec['worlds'][r] = row
    print(f'{r} worlds: {row}', flush=True)
  if cuda:
    usage = {name: u for name, u in _build.ptxas_usage().items()
             if 'threefry' in name}
    rec['registers'] = usage
    rec['blocks_per_sm'] = {m: prng_cuda.occupancy(m)
                            for m in ('split', 'bits', 'uniform')}
    print(f"registers {usage}; blocks of 256 threads an SM "
          f"{rec['blocks_per_sm']}", flush=True)
    print(card, flush=True)
  return rec


if __name__ == '__main__':
  main()
