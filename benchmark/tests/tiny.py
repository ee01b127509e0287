"""A copy of the benchmark at sizes a CPU test can hold: the same files,
with every traffic mix and the training configuration cut to a few envs
and ticks."""

from __future__ import annotations

import json
import pathlib
import shutil

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

TINY_TRAFFIC = {
    'group_loop': dict(num_envs=8, reset_batch=4, warmup_calls=1,
                       trace_calls=2),
    'tick_loop': dict(num_envs=8, reset_batch=2, warmup_calls=2,
                      trace_calls=2),
    'ppo_train': dict(trace_calls=1),
}
TINY_CHECK = {
    'group_loop': dict(init_envs=3, calls=2, call_span=2),
    'tick_loop': dict(init_envs=3, calls=2, call_span=2),
    'ppo_train': dict(steps=2),
}
TINY_PPO = dict(num_envs=8, rollout_len=4, epochs=1, minibatches=2,
                reset_batch=2)


def make_root(dest: pathlib.Path) -> pathlib.Path:
  """``dest`` holding ``BENCHMARK.json`` and a tiny ``benchmark/``."""
  shutil.copy(ROOT / 'BENCHMARK.json', dest / 'BENCHMARK.json')
  shutil.copytree(BENCH, dest / 'benchmark',
                  ignore=shutil.ignore_patterns('tests', '__pycache__'))
  for path in (dest / 'benchmark' / 'workloads').glob('*.json'):
    traffic = json.loads(path.read_text())
    driver = traffic['driver']
    traffic.update(TINY_TRAFFIC[driver])
    traffic['check'].update(TINY_CHECK[driver])
    path.write_text(json.dumps(traffic))
  for path in (dest / 'benchmark' / 'configs').glob('*.json'):
    config = json.loads(path.read_text())
    if 'policy' in config:
      config['assumed'].update(TINY_PPO)
      path.write_text(json.dumps(config))
  return dest
