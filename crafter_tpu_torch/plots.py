"""Plot and table generation for Crafter scores (the port's copy of
``crafter_tpu/plots.py``, on the port's ``analysis.py``).

Host-side equivalents of the reference's analysis scripts (reference:
analysis/plot_scores.py, plot_spectrum.py, plot_counts.py, plot_reward.py,
print_scores.py, print_spectrum.py, print_reward.py), driven from the score
JSONs produced by ``crafter_tpu_torch.analysis.read_stats``.  Figure
geometry and palette follow the reference's published charts so outputs
are visually comparable; the implementation is organized around three
shared helpers (legend resolution, per-method binned curves, figure save).

CLI: ``python -m crafter_tpu_torch.plots
scores|spectrum|reward|counts|tables --inpaths a.json b.json --outpath
plot.png``.  matplotlib is imported inside each plotting function, never
when this module is imported.
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

from . import analysis

COLORS = ('#377eb8', '#5fc35d', '#984ea3', '#bf3217', '#de9f42', '#6a554d',
          '#a65628', '#f781bf', '#888888', '#a6cee3', '#b2df8a', '#cab2d6',
          '#fb9a99', '#fdbf6f')


def _legend(runs, legend=None):
  """method -> display label, defaulting to title-cased method names."""
  if legend:
    return legend
  methods = sorted(set(run['method'] for run in runs))
  return {x: x.replace('_', ' ').title() for x in methods}


def _save(fig, outpath):
  pathlib.Path(outpath).parent.mkdir(exist_ok=True, parents=True)
  fig.savefig(outpath)
  return outpath


def _strip_spines(ax, sides=('top', 'right', 'bottom')):
  for side in sides:
    ax.spines[side].set_visible(False)


def _task_label(task):
  return task[len('achievement_'):].replace('_', ' ').title()


def _method_curves(runs, method, column, borders, transform=None):
  """Binned training curves of ``column`` for every run of a method."""
  curves = []
  for run in runs:
    if run['method'] != method:
      continue
    ys = np.asarray(run[column])
    if transform is not None:
      ys = transform(ys)
    _, binned = analysis.binning(run['xs'], ys, borders, fill='last')
    curves.append(binned)
  return curves


def plot_scores(inpaths, outpath, legend=None, colors=COLORS, budget=1e6,
                ylim=None):
  """Score bar chart (plot_scores.py:9-46)."""
  import matplotlib.pyplot as plt
  runs = analysis.load_runs(inpaths, budget)
  percents, methods, _, _ = analysis.compute_success_rates(runs, budget)
  scores = analysis.compute_scores(percents)
  legend = dict(reversed(_legend(runs, legend).items()))
  scores = scores[np.array([methods.index(m) for m in legend])]
  mean, std = np.nanmean(scores, -1), np.nanstd(scores, -1)

  fig, ax = plt.subplots(figsize=(4, 3))
  centers = np.arange(len(legend))
  ax.bar(centers, mean, yerr=std,
         color=list(reversed(list(colors)[:len(legend)])),
         error_kw=dict(capsize=5, c='#000'))
  _strip_spines(ax)
  ax.set_xticks(centers)
  ax.set_xticklabels(list(legend.values()), rotation=45, ha='right',
                     rotation_mode='anchor')
  ax.set_ylabel('Crafter Score (%)')
  if ylim:
    ax.set_ylim(0, ylim)
  fig.tight_layout()
  return _save(fig, outpath)


def plot_spectrum(inpaths, outpath, legend=None, colors=COLORS, budget=1e6,
                  sort=False):
  """Per-achievement log-scale success rates (plot_spectrum.py:9-48)."""
  import matplotlib.pyplot as plt
  runs = analysis.load_runs(inpaths, budget)
  legend = _legend(runs, legend)
  # The reference passes `sort and key`, and `False` *is* an int to
  # isinstance, accidentally sorting by method 0 (plot_spectrum.py:11-12);
  # pass None explicitly instead.
  percents, methods, _, tasks = analysis.compute_success_rates(
      runs, budget, sortby=list(legend.keys())[0] if sort else None)

  fig, ax = plt.subplots(figsize=(7, 3))
  centers = np.arange(len(tasks))
  width = 0.7
  for index, (method, label) in enumerate(legend.items()):
    heights = np.nanmean(percents[methods.index(method)], 0)
    pos = centers + width * (0.5 / len(methods) + index / len(methods) - 0.5)
    ax.bar(pos, heights, width / len(legend), label=label,
           color=colors[index % len(colors)])
  _strip_spines(ax)
  ax.set_xticks(centers)
  ax.set_xticklabels([_task_label(t) for t in tasks], rotation=45,
                     ha='right', rotation_mode='anchor')
  ax.set_ylabel('Success Rate (%)')
  ax.set_yscale('log')
  ax.set_ylim(0.01, 100)
  ax.set_yticks([0.01, 0.1, 1, 10, 100])
  ax.set_yticklabels('0.01 0.1 1 10 100'.split())
  fig.tight_layout(rect=(0, 0, 1, 0.95))
  fig.legend(loc='upper center', ncol=10, frameon=False, borderpad=0,
             borderaxespad=0)
  return _save(fig, outpath)


def plot_reward(inpaths, outpath, legend=None, colors=COLORS, budget=1e6):
  """Reward training curves with the optimal-22 line (plot_reward.py:10-54)."""
  import matplotlib.pyplot as plt
  runs = analysis.load_runs(inpaths, budget)
  legend = _legend(runs, legend)
  borders = np.arange(0, budget, 1e4)
  fig, ax = plt.subplots(figsize=(4, 3))
  ax.axhline(22, c='#888888', ls='--', lw=1)  # optimal = 22 achievements
  for index, (method, label) in enumerate(legend.items()):
    curves = _method_curves(runs, method, 'reward', borders)
    if not curves:
      continue
    mean, std = np.nanmean(curves, 0), np.nanstd(curves, 0)
    color = colors[index % len(colors)]
    ax.plot(borders[1:], mean, label=label, color=color)
    ax.fill_between(borders[1:], mean - std, mean + std, alpha=0.15,
                    color=color, lw=0)
  ax.set_xlabel('Environment Steps')
  ax.set_ylabel('Episode Reward')
  ax.legend(frameon=False)
  fig.tight_layout()
  return _save(fig, outpath)


def plot_counts(inpaths, outpath, legend=None, colors=COLORS, budget=1e6):
  """Per-achievement success-rate training curves (plot_counts.py:10-43)."""
  import matplotlib.pyplot as plt
  runs = analysis.load_runs(inpaths, budget)
  legend = _legend(runs, legend)
  tasks = sorted(key for key in runs[0] if key.startswith('achievement_'))
  borders = np.arange(0, budget, 1e4)
  rows = int(np.ceil(len(tasks) / 4))
  fig, axes = plt.subplots(rows, 4, figsize=(14, 2.2 * rows), sharex=True)
  unlocked_pct = lambda ys: 100 * (ys >= 1)
  for task, ax in zip(tasks, axes.flatten()):
    ax.set_title(_task_label(task))
    for index, (method, label) in enumerate(legend.items()):
      curves = _method_curves(runs, method, task, borders,
                              transform=unlocked_pct)
      if curves:
        ax.plot(borders[1:], np.nanmean(curves, 0), label=label,
                color=colors[index % len(colors)])
  axes.flatten()[0].legend(frameon=False, fontsize=8)
  fig.tight_layout()
  return _save(fig, outpath)


def print_scores(inpaths, legend=None, budget=1e6):
  """Score table (print_scores.py:6-24)."""
  runs = analysis.load_runs(inpaths, budget)
  legend = _legend(runs, legend)
  percents, methods, _, _ = analysis.compute_success_rates(runs, budget)
  scores = analysis.compute_scores(percents)
  lines = [
      f'{label:<20} {np.nanmean(scores[methods.index(m)]):6.1f} '
      f'± {np.nanstd(scores[methods.index(m)]):.1f}%'
      for m, label in legend.items()]
  out = '\n'.join(lines)
  print(out)
  return out


def print_spectrum(inpaths, legend=None, budget=1e6, sort=False):
  """Per-achievement table (print_spectrum.py:8-61)."""
  runs = analysis.load_runs(inpaths, budget)
  legend = _legend(runs, legend)
  percents, methods, _, tasks = analysis.compute_success_rates(
      runs, budget, sortby=list(legend.keys())[0] if sort else None)
  lines = [' ' * 26 + '  '.join(f'{label:>12}'
                                for label in legend.values())]
  for k, task in enumerate(tasks):
    row = [f'{np.nanmean(percents[methods.index(m), :, k]):11.1f}%'
           for m in legend]
    lines.append(f'{_task_label(task):<26}'
                 + '  '.join(f'{v:>12}' for v in row))
  out = '\n'.join(lines)
  print(out)
  return out


def print_reward(inpaths, legend=None, budget=1e6, last=1e5):
  """Final-reward table (print_reward.py:6-31).

  Per method and seed, the reported reward is the episode reward at the
  start of the final ``last`` env steps of the budget; rows are printed as
  LaTeX table lines like the reference (the output format is the spec).
  """
  runs = analysis.load_runs(inpaths, budget)
  legend = _legend(runs, legend)
  per_method = {}
  for run in runs:
    xs, ys = np.asarray(run['xs']), np.asarray(run['reward'])
    in_window = int((xs >= xs.max() - last).sum())
    per_method.setdefault(run['method'], []).append(ys[-in_window])
  lines = ['', r'\textbf{Method} & \textbf{Reward} \\', '']
  for method, label in legend.items():
    vals = np.asarray(per_method.get(method, [np.nan]), np.float64)
    mean = f'{np.nanmean(vals):.1f}'
    pad = r'\o' if len(mean) < 4 else ' '
    lines.append(rf'{label:<25} & ${pad}{mean} \pm {np.nanstd(vals):4.1f}$ \\')
  lines.append('')
  out = '\n'.join(lines)
  print(out)
  return out


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('kind', choices=[
      'scores', 'spectrum', 'reward', 'counts', 'tables'])
  parser.add_argument('--inpaths', nargs='+', required=True)
  parser.add_argument('--outpath', type=str, default='plot.png')
  parser.add_argument('--budget', type=float, default=1e6)
  args = parser.parse_args(argv)
  makers = dict(scores=plot_scores, spectrum=plot_spectrum,
                reward=plot_reward, counts=plot_counts)
  if args.kind in makers:
    makers[args.kind](args.inpaths, args.outpath, budget=args.budget)
    print('Saved', args.outpath)
  else:
    print_scores(args.inpaths, budget=args.budget)
    print()
    print_spectrum(args.inpaths, budget=args.budget)
    print_reward(args.inpaths, budget=args.budget)


if __name__ == '__main__':
  main()
