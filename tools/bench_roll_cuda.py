"""Micro-bench: what does a cross-lane rotate cost inside a CUDA kernel?

The counterpart, for an NVIDIA GPU, of ``tools/bench_roll.py``.  It times
the kernel of ``crafter_tpu_torch/csrc/roll.cu``: R successive
roll-and-select stages on (n, 4096) int32 rows, each rotate an exchange
through shared memory behind a barrier (or, for shifts of whole thread
strides, a move between registers), against an arithmetic control of the
same stage count that stays in registers.  Prints each kind's blocks an
SM, shared memory a block and ring depth, ms and us/stage for the six
(kind, R) pairs, 'roll' at 10 stages five times by events and by the
profiler against its byte bound, and the time of one ``torch.roll`` of the
same rows (one stage's rotate as a library call) and of a clone of them
(the bytes alone), each line with the card's name and power limit.

Run on a machine with a GPU and nvcc: python tools/bench_roll_cuda.py [n_rows]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('bench_roll_cuda: needs a CUDA device')
  from crafter_tpu_torch.ops import roll_cuda
  from crafter_tpu_torch.utils import card_line

  n = int(sys.argv[1]) if len(sys.argv) > 1 else 40960
  card = card_line()
  gen = torch.Generator(device='cuda')
  gen.manual_seed(0)
  x = torch.randint(0, 1 << 24, (n, roll_cuda.COLS), generator=gen,
                    device='cuda', dtype=torch.int32)

  def timed(fn, reps=5):
    """Best of ``reps`` calls after a warm-up, in ms (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(reps):
      spans.append([torch.cuda.Event(enable_timing=True) for _ in range(2)])
      spans[-1][0].record()
      fn()
      spans[-1][1].record()
    torch.cuda.synchronize()
    return min(t0.elapsed_time(t1) for t0, t1 in spans)

  def device_ms(fn, reps=5):
    """The kernel's mean device time over ``reps`` calls after a warm-up
    (torch.profiler: the launches it recorded), in ms; None where it
    recorded none."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) as prof:
      for _ in range(reps):
        fn()
      torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and 'roll_kernel' in e.key]
    launches = sum(e.count for e in events)
    return (sum(e.self_device_time_total for e in events) / 1e3 / launches
            if launches else None)

  head = x[:256]
  for kind in roll_cuda.KINDS:
    blocks, smem, depth = roll_cuda.occupancy(kind)
    print(f'{kind:5}: {blocks} blocks of 256 threads an SM, {smem} bytes of '
          f'shared memory a block, a ring of {depth} rows')
    for stages in (10, 40):
      if not torch.equal(roll_cuda.roll_stages(head, kind, stages),
                         roll_cuda.roll_stages_plain(head, kind, stages)):
        raise SystemExit(f'bench_roll_cuda: {kind} x{stages} disagrees with '
                         'its plain version')
      ms = timed(lambda: roll_cuda.roll_stages(x, kind, stages))
      print(f'{kind:5} x{stages:3}: {ms:7.3f} ms '
            f'({ms * 1e3 / stages / (n / 40960):6.2f} us/stage @40960rows) '
            f'[{card}]')
  # 'roll' at 10 stages against the bound (one read and one write of the
  # rows over 3.35 TB/s), five times each way.
  bound = 2 * x.numel() * 4 / 3.35e12 * 1e3
  call = lambda: roll_cuda.roll_stages(x, 'roll', 10)
  for what, fn in (('events', timed), ('profiler', device_ms)):
    ts = [fn(call) for _ in range(5)]
    print(f'roll  x 10 by {what}: ' + ', '.join(
        'not measured' if t is None else f'{t:.4f} ms ({bound / t:.1%})'
        for t in ts) + f' of the bound {bound:.4f} ms [{card}]')
  ms = timed(lambda: torch.roll(x, -1, dims=1))
  print(f'torch.roll, one stage\'s rotate: {ms:7.3f} ms [{card}]')
  ms = timed(x.clone)
  print(f'a clone of the rows (the same bytes, no stage): {ms:7.3f} ms '
        f'[{card}]')


if __name__ == '__main__':
  main()
