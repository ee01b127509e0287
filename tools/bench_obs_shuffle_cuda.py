"""Micro-bench: layouts for the PPO minibatch obs gather + cast, on one GPU.

The counterpart of ``tools/bench_obs_shuffle.py`` for ``crafter_tpu_torch``.
The learn stage gathers minibatches of (B, 64, 64, 3) uint8 frames at
random rows and casts them to bfloat16 / 255 for the policy
(``crafter_tpu_torch/ppo.py:_learn``, ``models/cnn.py:CnnPolicy.forward``).
Each case gathers a minibatch, runs ``consume`` (the policy's input stage,
``(x.to(bfloat16) / 255).sum(dtype=float32)``) and repeats over the M
minibatches of one epoch, as the JAX tool's cases do:

  nhwc         (B, 64, 64, 3) u8 rows, gather + convert/255
  flat         (B, 12288) u8 rows, gather, reshape + convert
  packed       (B, 4096) int32 r|g<<8|b<<16, gather, unpack + convert
  epoch        nhwc, one whole-batch gather an epoch + contiguous slices
  contig       no shuffle: contiguous slices (the floor)
  nhwc_sorted  nhwc, indices sorted within each minibatch
  flat_sorted  flat, the same
  flat_once3   one whole-batch flat gather, then 3 epochs of slices (the
               port's own scheme, ppo.py's one gather an update); its
               "ms/epoch" is the time of all 3, as in the JAX tool

The data are the JAX tool's: ``jax.random.bits(key(0), (B, 12288), uint8)``
(the low byte of threefry's 32 bits, drawn here in row chunks) and
``jax.random.permutation(key(1), B)``.  Every case consumes every row once
an epoch (``flat_once3`` three times), so each case's sum must equal
``nhwc``'s within a relative 1e-4 (three times it for ``flat_once3``), or
the tool stops with an error.

Prints the JAX tool's line a case (best of ``--reps`` after a warm-up,
CUDA events on a GPU), then on a GPU each case's byte bound (the gather's
rows read and written once and the cast's u8 read and bfloat16 written
once, over the H100 SXM's 3.35 TB/s), the peak device memory and the
card's name and power limit.  ``main(argv)`` returns the record.

    python tools/bench_obs_shuffle_cuda.py --batch 262144 --minibatches 8
    python tools/bench_obs_shuffle_cuda.py --device cpu --batch 64 --reps 1

``--device cpu`` runs the same PyTorch code on the CPU at the sizes given
(its times are the CPU's).  Without a GPU the default run stops with an
error.
"""

import pathlib as _pathlib
import sys as _sys

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402
import time  # noqa: E402

FRAME = (64, 64, 3)
ROW = 64 * 64 * 3          # bytes a frame
DRAW_CHUNK = 8192          # rows a threefry draw (int64 words: ~0.8 GB)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
TOLERANCE = 1e-4           # relative, between the cases' sums


def make_data(b: int, device, chunk: int = DRAW_CHUNK):
  """``(flat, nhwc, packed, perm)``: the JAX tool's frames as (b, 12288)
  uint8 rows, their (b, 64, 64, 3) view, the (b, 4096) int32 lanes
  ``r | g<<8 | b<<16`` and ``jax.random.permutation(key(1), b)``."""
  import torch
  from crafter_tpu_torch import prng
  key = prng.key(0, device)
  flat = torch.empty((b, ROW), dtype=torch.uint8, device=device)
  for start in range(0, b, chunk):
    rows = min(chunk, b - start)
    bits = prng.random_bits(key, (rows, ROW), rows=(start, b))
    flat[start:start + rows] = (bits & 255).to(torch.uint8)
    del bits
  quad = torch.zeros((b, ROW // 3, 4), dtype=torch.uint8, device=device)
  quad[..., :3] = flat.reshape(b, ROW // 3, 3)
  packed = quad.view(torch.int32).reshape(b, ROW // 3)
  perm = prng.permutation(prng.key(1, device), b)
  return flat, flat.reshape((b,) + FRAME), packed, perm


def consume(x):
  """The model's input stage: bfloat16 NHWC / 255, summed in float32."""
  import torch
  return (x.to(torch.bfloat16) / 255.0).sum(dtype=torch.float32)


def _frames(x):
  return x.reshape((x.shape[0],) + FRAME)


def _unpack(w):
  """int32 lanes -> (rows, 64, 64, 3) uint8: a byte view, the 4 -> 3 slice."""
  import torch
  b = w.contiguous().view(torch.uint8).reshape(w.shape[0], ROW // 3, 4)
  return b[..., :3].reshape((w.shape[0],) + FRAME)


def _gathered(view):
  """A case that gathers each minibatch's rows by index."""
  def run(data, perm, m, sort=False):
    idxs = perm.reshape(m, -1)
    if sort:
      idxs = idxs.sort(dim=1).values
    s = 0.0
    for idx in idxs:
      s = s + consume(view(data[idx]))
    return s
  return run


def _sliced(shuffle, epochs=1):
  """A case that consumes contiguous slices of one (shuffled) copy."""
  def run(data, perm, m):
    src = data[perm] if shuffle else data
    mb = data.shape[0] // m
    s = 0.0
    for _ in range(epochs):
      for i in range(m):
        s = s + consume(_frames(src[i * mb:(i + 1) * mb]))
    return s
  return run


_nhwc, _flat = _gathered(lambda x: x), _gathered(_frames)
# (name, function, layout, gathers an epoch of the rows' bytes: a minibatch
# at a time or once; 0 for none; flat_once3's one gather serves 3 epochs)
CASES = (
    ('nhwc', _nhwc, 'nhwc', 1),
    ('flat', _flat, 'flat', 1),
    ('packed', _gathered(_unpack), 'packed', 1),
    ('epoch', _sliced(True), 'nhwc', 1),
    ('contig', _sliced(False), 'nhwc', 0),
    ('nhwc_sorted', lambda d, p, m: _nhwc(d, p, m, sort=True), 'nhwc', 1),
    ('flat_sorted', lambda d, p, m: _flat(d, p, m, sort=True), 'flat', 1),
    ('flat_once3', _sliced(True, epochs=3), 'flat', 1),
)
EPOCHS = {'flat_once3': 3}


def bound_ms(name: str, b: int) -> tuple[float, float, float]:
  """``(ms, gather GB, cast GB)`` of a case's call at the H100's memory
  rate: the gathered rows read and written once (4/3 the bytes in the
  packed layout), the cast's u8 read and bfloat16 written once an epoch."""
  layout, gathers = next((c[2], c[3]) for c in CASES if c[0] == name)
  frame_bytes = b * ROW
  gather = 2 * gathers * frame_bytes * (4 / 3 if layout == 'packed' else 1)
  cast = 3 * frame_bytes * EPOCHS.get(name, 1)
  return (gather + cast) / HBM_BYTES_PER_S * 1e3, gather / 1e9, cast / 1e9


def run_cases(data: dict, perm, m: int, reps: int, dev):
  """``{name: (best ms, sum)}`` of every case, each timed ``reps`` times
  after a warm-up."""
  import torch
  out = {}
  for name, fn, layout, _ in CASES:
    x = data[layout]
    total = float(fn(x, perm, m))                     # warm-up
    best = float('inf')
    for _ in range(reps):
      if dev.type == 'cuda':
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn(x, perm, m)
        end.record()
        torch.cuda.synchronize(dev)
        ms = start.elapsed_time(end)
      else:
        t0 = time.perf_counter()
        float(fn(x, perm, m))
        ms = (time.perf_counter() - t0) * 1e3
      best = min(best, ms)
    out[name] = (best, total)
    print(f'{name:<8} {best:8.1f} ms/epoch ({best * 3:8.1f} ms per 3-epoch '
          'update)', flush=True)
  return out


def check_sums(sums: dict) -> None:
  """Every case consumed what ``nhwc`` did (``flat_once3`` three times),
  within a relative TOLERANCE; stops the tool otherwise."""
  ref = sums['nhwc']
  for name, s in sums.items():
    want = ref * EPOCHS.get(name, 1)
    if not abs(s - want) <= TOLERANCE * abs(want):
      raise SystemExit(f'bench_obs_shuffle_cuda: {name} consumed {s!r}, '
                       f'want {want!r} (nhwc {ref!r}) within {TOLERANCE}')


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--batch', type=int, default=262144)
  parser.add_argument('--minibatches', type=int, default=8)
  parser.add_argument('--reps', type=int, default=3)
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  from crafter_tpu_torch.utils import tool_device
  dev, card = tool_device(args.device, 'bench_obs_shuffle_cuda')
  import torch

  b, m = args.batch, args.minibatches
  if b % m:
    raise SystemExit(f'bench_obs_shuffle_cuda: --batch {b} is not a '
                     f'multiple of --minibatches {m}')
  if dev.type == 'cuda':
    torch.cuda.reset_peak_memory_stats(dev)
  t0 = time.perf_counter()
  flat, nhwc, packed, perm = make_data(b, dev)
  if dev.type == 'cuda':
    torch.cuda.synchronize(dev)
  data_s = time.perf_counter() - t0
  results = run_cases({'nhwc': nhwc, 'flat': flat, 'packed': packed}, perm,
                      m, args.reps, dev)
  sums = {name: s for name, (_, s) in results.items()}
  check_sums(sums)
  print(f'consumption: every case summed nhwc\'s {sums["nhwc"]!r} '
        f'(flat_once3 three times) within {TOLERANCE}', flush=True)
  rec = {'batch': b, 'minibatches': m, 'reps': args.reps,
         'ms': {name: ms for name, (ms, _) in results.items()},
         'sums': sums, 'data_s': data_s, 'device': str(dev), 'card': card,
         'peak_bytes': None, 'bound_ms': None}
  if dev.type == 'cuda':
    rec['bound_ms'] = {}
    for name, _, _, _ in CASES:
      ms, gather, cast = bound_ms(name, b)
      rec['bound_ms'][name] = ms
      print(f'{name:<11} bound {ms:7.2f} ms (gather {gather:.2f} GB + cast '
            f'{cast:.2f} GB at 3.35 TB/s), measured '
            f'{results[name][0] / ms:.1f}x it', flush=True)
    rec['peak_bytes'] = torch.cuda.max_memory_allocated(dev)
    print(f'peak device memory {rec["peak_bytes"] / 1e9:.2f} GB; data drawn '
          f'in {data_s:.1f} s', flush=True)
    print(card, flush=True)
  return rec


if __name__ == '__main__':
  main()
