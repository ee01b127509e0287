"""Aggregate a training logdir into score JSONs and print Crafter scores.

The counterpart of ``tools/score_run.py`` for ``crafter_tpu_torch``: the
port's ``analysis`` pipeline (``read_stats``, ``crafter_score``,
``load_runs``, ``print_summary``) on every ``stats.jsonl`` under a logdir.

Usage: python tools/score_run_cuda.py <logdir> <task> <method> [budget]
Writes scores/<task>-<method>.json under the working directory (same
format as the reference's analysis/read_metrics.py) and prints the score
table.  It reads files only, so it needs no card.
"""

import pathlib as _pathlib
import sys as _sys

# Runnable as a plain script: put the repo root on sys.path so
# crafter_tpu_torch imports without an installed package.
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

from crafter_tpu_torch import analysis  # noqa: E402


def main(argv=None):
  """Prints the score line and the summary; returns the score file, or
  None when no run is complete."""
  argv = _sys.argv[1:] if argv is None else list(argv)
  logdir = argv[0]
  task = argv[1] if len(argv) > 1 else 'crafter_reward'
  method = argv[2] if len(argv) > 2 else 'ppo'
  budget = int(float(argv[3])) if len(argv) > 3 else int(1e6)
  out = analysis.read_stats(logdir, 'scores', task, method, budget)
  if out is None:
    print('No complete runs found in', logdir)
    return None
  mean, std = analysis.crafter_score([out], budget)
  print(f'{method}: crafter score {float(mean[0]):.2f} '
        f'± {float(std[0]):.2f} % ({out})')
  analysis.print_summary(analysis.load_runs([out], budget), budget,
                         verbose=True)
  return out


if __name__ == '__main__':
  main()
