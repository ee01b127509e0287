"""Micro-bench: what does a cross-lane rotate cost inside a CUDA kernel?

The counterpart, for an NVIDIA GPU, of ``tools/bench_roll.py``.  It times
the kernel of ``crafter_tpu_torch/csrc/roll.cu``: R successive roll-and-select
stages on (n, 4096) int32 rows, each a shared-memory round trip and a
barrier, against an arithmetic control of the same stage count that stays
in registers.  Prints ms and us/stage for the six (kind, R) pairs, and the
time of one ``torch.roll`` of the same rows (one stage's rotate as a
library call), each line with the card's name and power limit.

Run on a machine with a GPU and nvcc: python tools/bench_roll_cuda.py [n_rows]
"""

import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('bench_roll_cuda: needs a CUDA device')
  from crafter_tpu_torch.ops import roll_cuda

  n = int(sys.argv[1]) if len(sys.argv) > 1 else 40960
  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True,
      timeout=60).stdout.strip().splitlines()[0]
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

  head = x[:256]
  for kind in roll_cuda.KINDS:
    for stages in (10, 40):
      if not torch.equal(roll_cuda.roll_stages(head, kind, stages),
                         roll_cuda.roll_stages_plain(head, kind, stages)):
        raise SystemExit(f'bench_roll_cuda: {kind} x{stages} disagrees with '
                         'its plain version')
      ms = timed(lambda: roll_cuda.roll_stages(x, kind, stages))
      print(f'{kind:5} x{stages:3}: {ms:7.3f} ms '
            f'({ms * 1e3 / stages / (n / 40960):6.2f} us/stage @40960rows) '
            f'[{card}]')
  ms = timed(lambda: torch.roll(x, -1, dims=1))
  print(f'torch.roll, one stage\'s rotate: {ms:7.3f} ms [{card}]')


if __name__ == '__main__':
  main()
