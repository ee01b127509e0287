"""The readings that the limits of ``correct`` are set from: a cell's
checks on several seeds in one process, for the program as it is, for the
lower-precision control in the program's place, or for the program with a
fault planted underneath.  The benchmark's own runs never run this.

    python3 benchmark/calibrate.py --workload group_state \\
        --seeds 11 12 13 --seconds 4 [--variant control] [--fault unchanged]

Prints one JSON line a seed: the seed, what ran, ``correct`` and every
number compared beside its limit.

Faults (``FAULTS``), each planted where the cell's entry produces it:
``unchanged`` a step that returns its state unchanged; ``half_batch``
half of the batch left out (the env's second half not stepped; the PPO
loss and its mean over the first half of each minibatch); ``altered`` one
answer altered where it is produced (one reward of the env; one sampled
action of each tick of the rollout).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from benchmark import run  # noqa: E402


def _patch(owner, name, make):
  original = getattr(owner, name)
  setattr(owner, name, make(original))
  return lambda: setattr(owner, name, original)


def _half(tree, n):
  """Leaves with a leading env axis of ``n``: the first half's rows."""
  if dataclasses.is_dataclass(tree):
    return type(tree)(**{f.name: _half(getattr(tree, f.name), n)
                         for f in dataclasses.fields(tree)})
  return tree[:n // 2] if tree.ndim and tree.shape[0] == n else tree


def _join_half(new, old, n):
  """``new``'s rows for the first half, ``old``'s for the rest."""
  import torch
  if dataclasses.is_dataclass(new):
    return type(new)(**{f.name: _join_half(getattr(new, f.name),
                                           getattr(old, f.name), n)
                        for f in dataclasses.fields(new)})
  if old.ndim and old.shape[0] == n:
    return torch.cat([new, old[n // 2:]])
  return new


@contextlib.contextmanager
def fault(driver: str, name: str):
  """Plant fault ``name`` under the entry of ``driver`` for the block."""
  import crafter_tpu_torch.env as ct_env
  import crafter_tpu_torch.ppo as ct_ppo
  undo = []
  if driver == 'group_loop':
    def group(original):
      def step(vs, actions, cfg, reset_batch):
        if name == 'half_batch':
          n = actions.shape[1]
          part, outs = original(_half(vs, n), actions[:, :n // 2], cfg,
                                reset_batch)
          return _join_half(part, vs, n), outs
        out_vs, outs = original(vs, actions, cfg, reset_batch)
        if name == 'unchanged':
          return vs, outs
        outs.reward[0, 0] += 1.0
        return out_vs, outs
      return step
    undo.append(_patch(ct_env, 'vec_step_group', group))
  elif driver == 'tick_loop':
    def tick(original):
      def step(vs, actions, cfg, reset_batch, **kw):
        if name == 'half_batch':
          n = actions.shape[0]
          part, out, stepped = original(_half(vs, n), actions[:n // 2], cfg,
                                        max(1, reset_batch // 2), **kw)
          return _join_half(part, vs, n), out, stepped
        out_vs, out, stepped = original(vs, actions, cfg, reset_batch, **kw)
        if name == 'unchanged':
          return vs, out, stepped
        out.reward[0] += 1.0
        return out_vs, out, stepped
      return step
    undo.append(_patch(ct_env, 'vec_step', tick))
  elif driver == 'ppo_train':
    if name == 'unchanged':
      def no_step(original):
        def sgd_step(self, ts, mb):
          ts.opt_state.zero_grad(set_to_none=True)
          loss, aux = self._loss(ts.params, mb)
          loss.backward()
          return dict(loss=loss.detach(),
                      **{k: v.detach() for k, v in aux.items()})
        return sgd_step
      undo.append(_patch(ct_ppo.PPO, '_sgd_step', no_step))
    elif name == 'half_batch':
      def half_loss(original):
        def loss(self, policy, batch):
          return original(self, policy,
                          tuple(x[:x.shape[0] // 2] for x in batch))
        return loss
      undo.append(_patch(ct_ppo.PPO, '_loss', half_loss))
    else:
      def altered(original):
        def categorical(key, logits, rows=None):
          action = original(key, logits, rows)
          action[0] = (action[0] + 1) % logits.shape[-1]
          return action
        return categorical
      undo.append(_patch(ct_ppo.prng, 'categorical', altered))
  try:
    yield
  finally:
    for u in reversed(undo):
      u()


FAULTS = ('unchanged', 'half_batch', 'altered')


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
  from benchmark import harness
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
