"""Offline evaluation: the Crafter score and its data pipeline (the port's
own copy of ``crafter_tpu/analysis.py``).

The benchmark's metric is a *budgeted geometric mean of achievement success
rates*: within a 1M-env-step budget, each of the 22 achievements gets a
success rate p_t (percent of episodes that unlocked it at least once), and

    score = exp( mean_t( log(1 + p_t) ) ) - 1

(the +1 offset keeps never-unlocked tasks finite; reference:
analysis/common.py:47-55).  Everything in this module exists to produce,
aggregate, or consume those rates in the reference's interchange formats —
``stats.jsonl`` episode logs and ``scores/{task}-{method}.json`` run files —
so results are comparable number-for-number.  The golden tests reproduce
the published values from the reference's bundled score JSONs (random
1.6 ± 0.0, human 50.5 ± 6.8; README.md:147,153).
"""

from __future__ import annotations

import json
import pathlib
import warnings

import numpy as np

ACH_PREFIX = 'achievement_'


def compute_scores(percents: np.ndarray) -> np.ndarray:
  """Crafter score over the trailing task axis (analysis/common.py:47-55).

  NaN entries (missing method x seed combinations) pass the range guard
  and propagate through ``nanmean`` as in the rest of the pipeline.
  """
  ok = ((0 <= percents) & (percents <= 100)) | np.isnan(percents)
  assert ok.all()
  with warnings.catch_warnings():
    warnings.simplefilter('ignore', category=RuntimeWarning)
    return np.exp(np.nanmean(np.log(1 + percents), -1)) - 1


def run_success_rates(run: dict, budget: float) -> dict:
  """One run's per-achievement success %, episodes truncated at budget."""
  n = int((np.asarray(run['xs']) <= budget).sum())
  return {key: 100.0 * (np.asarray(values[:n]) >= 1).mean()
          for key, values in run.items() if key.startswith(ACH_PREFIX)}


def compute_success_rates(runs, budget=1e6, sortby=None):
  """(methods, seeds, tasks) percent tensor from a list of runs.

  Semantics follow analysis/common.py:23-44: axes are the sorted unique
  methods/seeds, tasks are the sorted achievement keys, missing
  (method, seed) combinations stay NaN.  ``sortby`` (a method name or
  index) reorders tasks by that method's mean rate, descending.
  """
  methods = sorted({run['method'] for run in runs})
  seeds = sorted({run['seed'] for run in runs})
  tasks = sorted(k for k in runs[0] if k.startswith(ACH_PREFIX))
  index = {(m, s): (i, j) for i, m in enumerate(methods)
           for j, s in enumerate(seeds)}
  percents = np.full((len(methods), len(seeds), len(tasks)), np.nan)
  for run in runs:
    i, j = index[(run['method'], run['seed'])]
    rates = run_success_rates(run, budget)
    percents[i, j] = [rates.get(t, np.nan) for t in tasks]
  if sortby is not None:
    ref = methods.index(sortby) if isinstance(sortby, str) else sortby
    order = np.argsort(-np.nanmean(percents[ref], 0))
    percents = percents[..., order]
    tasks = [tasks[k] for k in order]
  return percents, methods, seeds, tasks


def load_runs(filenames, budget=1e6, verbose=False):
  """Load score-JSON files (each a run dict or a list of run dicts)."""
  runs = []
  for filename in filenames:
    loaded = json.loads(pathlib.Path(filename).read_text())
    for run in [loaded] if isinstance(loaded, dict) else loaded:
      if verbose and run['xs'][-1] < budget - 1e4:
        print(f'Run contains only {run["xs"][-1]} steps')
      runs.append(run)
  return runs


def binning(xs, ys, borders, reducer=np.nanmean, fill='nan'):
  """Reduce (xs, ys) samples into border-delimited buckets (curves).

  Matches analysis/common.py:58-75: bucket (a, b] holds samples with
  a < x <= b; empty buckets are NaN or carry the last value (``fill``).
  Implemented with one searchsorted over the sorted xs.
  """
  xs, ys = np.asarray(xs), np.asarray(ys)
  order = np.argsort(xs)
  xs, ys = xs[order], ys[order]
  edges = np.searchsorted(xs, np.asarray(borders), side='right')
  out = []
  with warnings.catch_warnings():
    warnings.simplefilter('ignore', category=RuntimeWarning)
    for left, right in zip(edges[:-1], edges[1:]):
      if right > left:
        out.append(reducer(ys[left:right]))
      elif fill == 'last' and out:
        out.append(out[-1])
      else:
        out.append(np.nan)
  return borders[1:], np.array(out)


# ---------------------------------------------------------------------------
# stats.jsonl -> score-JSON aggregation (analysis/read_metrics.py surface).
# ---------------------------------------------------------------------------


def load_stats(filename, budget=int(1e6)):
  """Parse one ``stats.jsonl`` into (rewards, lengths, achievements).

  Episodes stop at the budget (the episode crossing it is dropped), and the
  reported reward is *recomputed* from the episode's unlock count as
  ``unlocks - 0.9`` — the score pipeline's canonical reward, independent of
  what reward signal the env emitted (read_metrics.py:45-64).
  """
  episodes = []
  steps = 0
  for line in pathlib.Path(filename).read_text().splitlines():
    if not line.strip():
      continue
    episode = json.loads(line)
    steps += episode['length']
    if steps > budget:
      break
    episodes.append(episode)
  lengths = [ep['length'] for ep in episodes]
  achievements = {key: [ep[key] for ep in episodes]
                  for key in (episodes[0] if episodes else {})
                  if key.startswith(ACH_PREFIX)}
  rewards = [
      sum(int(ep[key] >= 1) for key in achievements) - 0.9
      for ep in episodes]
  return rewards, lengths, achievements


def read_stats(indir, outdir, task, method, budget=int(1e6)):
  """Aggregate ``indir/**/stats.jsonl`` into ``outdir/{task}-{method}.json``.

  Each stats file becomes one run (seed = its index); runs shorter than
  the budget are skipped (read_metrics.py:10-42).
  """
  indir, outdir = pathlib.Path(indir), pathlib.Path(outdir)
  runs = []
  for index, filename in enumerate(sorted(indir.glob('**/stats.jsonl'))):
    rewards, lengths, achievements = load_stats(filename, budget)
    if sum(lengths) < budget - 1e4:
      print(f'Skipping incomplete run ({sum(lengths)} steps): {filename}')
      continue
    runs.append(dict(
        task=task, method=method, seed=str(index),
        xs=np.cumsum(lengths).tolist(), reward=rewards, length=lengths,
        **achievements))
  if not runs:
    return None
  outdir.mkdir(exist_ok=True, parents=True)
  out = outdir / f'{task}-{method}.json'
  out.write_text(json.dumps(runs))
  return out


def print_summary(runs, budget=int(1e6), verbose=False):
  """Per-run summary table (read_metrics.py:68-81): score / reward /
  length / episode means ± std across the runs, plus the per-achievement
  success spectrum when ``verbose``."""
  episodes = np.array([len(x['length']) for x in runs])
  rewards = np.array([np.mean(x['reward']) for x in runs])
  lengths = np.array([np.mean(x['length']) for x in runs])
  percents, _, _, tasks = compute_success_rates(runs, budget, sortby=0)
  scores = np.squeeze(compute_scores(percents))
  print(f'Score:        {np.mean(scores):10.2f} ± {np.std(scores):.2f}')
  print(f'Reward:       {np.mean(rewards):10.2f} ± {np.std(rewards):.2f}')
  print(f'Length:       {np.mean(lengths):10.2f} ± {np.std(lengths):.2f}')
  print(f'Episodes:     {np.mean(episodes):10.2f} ± {np.std(episodes):.2f}')
  if verbose:
    spectrum = np.squeeze(percents).reshape(-1, len(tasks))
    for task, percent in zip(tasks, spectrum.T):
      name = task[len('achievement_'):].replace('_', ' ').title()
      print(f'{name:<20}  {np.mean(percent):6.2f}%')


def crafter_score(filenames, budget=1e6):
  """Mean ± std Crafter score across seeds for a set of score JSONs."""
  percents, _, _, _ = compute_success_rates(load_runs(filenames, budget),
                                            budget)
  scores = compute_scores(percents)
  return np.nanmean(scores, -1), np.nanstd(scores, -1)
