"""The readings that the limits of ``correct`` are set from: a cell's
checks on several seeds in one process, for the program as it is, for the
lower-precision control in the program's place, or for the program with a
fault planted underneath.  The benchmark's own runs never run this.

    python3 benchmark/calibrate.py --workload group_state \\
        --seeds 11 12 13 --seconds 4 [--variant control] [--fault unchanged]

Prints one JSON line a seed: the seed, what ran, ``correct`` and every
number compared beside its limit.

Faults (``FAULTS``), each planted by the cell's driver module
(``drivers/<driver>.py``, its ``fault(name)``) where the cell's entry
produces it: ``unchanged`` a step that returns its state unchanged;
``half_batch`` half of the batch left out (the env's second half not
stepped; the PPO loss and its mean over the first half of each
minibatch); ``altered`` one answer altered where it is produced (one
reward of the env; one sampled action of each tick of the rollout).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from benchmark import harness, run  # noqa: E402


FAULTS = ('unchanged', 'half_batch', 'altered')


def fault(driver: str, name: str, root: pathlib.Path = harness.ROOT):
  """The context manager that plants fault ``name`` under the entry of
  ``driver``: the ``fault`` of ``benchmark/drivers/<driver>.py``.  A
  driver without one stops the run, naming it: a fault that plants
  nothing would read as the program."""
  if name not in FAULTS:
    raise ValueError(f'fault {name!r} is not one of {FAULTS}')
  module = harness.load_module('drivers', driver, root)
  if not hasattr(module, 'fault'):
    raise SystemExit(f'benchmark/drivers/{driver}.py has no fault(name): '
                     'no fault can be planted under its entry')
  return module.fault(name)


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seeds', type=int, nargs='+', required=True)
  parser.add_argument('--seconds', type=float, required=True)
  parser.add_argument('--variant', choices=('program', 'control'),
                      default='program')
  parser.add_argument('--fault', choices=FAULTS)
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  cell = harness.load_cell(args.workload)
  for seed in args.seeds:
    t0 = time.perf_counter()
    with (fault(cell.traffic['driver'], args.fault) if args.fault
          else contextlib.nullcontext()):
      rec = run.run_cell(args.workload, seed, args.seconds, False,
                         device=args.device, t0=t0, variant=args.variant)
    print(json.dumps(dict(
        seed=seed, workload=args.workload, variant=args.variant,
        fault=args.fault, correct=rec['correct'], checks=rec['checks'],
        metrics=rec['metrics'], phases=rec['phases'])),
        flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
