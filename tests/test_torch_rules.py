"""``rules.override_rules`` in the port against the JAX package's.

Both packages get health max = initial = 5 (the pattern of
``tests/test_rules.py:test_override_rules_roundtrip``).  The port's cached
rule tensors (``step._tables``) and the kernels' rules blob
(``step_cuda._rules_blob``), both built before the override, must show the
new values; the initial player record and three ticks of 13 dense states
must equal the JAX package's, which traces fresh functions after its
override.  The default rules come back in both packages whatever happens.
Tolerance: none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from crafter_tpu import rules as jrules
from crafter_tpu import state as jstate
from crafter_tpu import step as jstep
from crafter_tpu.config import EnvConfig as JaxConfig
from crafter_tpu_torch import convert, rules, step_cuda
from crafter_tpu_torch import state as state_lib
from crafter_tpu_torch import step as step_lib
from crafter_tpu_torch.config import EnvConfig
from crafter_tpu_torch.env import step_batch
import dense_states
from one_thread import one_torch_thread  # noqa: F401
from test_torch_dense import _concat, _to_jax
from test_torch_step import _assert_same, _to_numpy

CFG = EnvConfig(noise_mode='fast')
H = rules.ITEM_HEALTH


def _health5(r):
  r['items']['health'].update(max=5, initial=5)


def _cached_health_max():
  # item_max is the first block of the rules blob (step_cuda._rules_blob).
  return (int(step_lib._tables('cpu')['item_max'][H]),
          int(step_cuda._rules_blob('cpu')[H]))


def test_override_rules_reaches_cached_tables_and_matches_jax():
  assert _cached_health_max() == (9, 9)     # cached before the override
  try:
    jrules.override_rules(_health5)
    rules.override_rules(_health5)
    assert _cached_health_max() == (5, 5)
    jcfg = JaxConfig()

    ref = jax.jit(lambda: jstate.init_player(jcfg))()
    ours = state_lib.init_player(CFG, 13, 'cpu')
    for name, want in vars(_to_numpy(ref)).items():
      got = getattr(ours, name).numpy()
      np.testing.assert_array_equal(got, np.broadcast_to(want, got.shape),
                                    err_msg=name)
    assert bool((ours.inventory[:, H] == 5).all())

    dense = dense_states.dense_states(8, seed=11)
    scenes, scene_acts = dense_states.scene_states()
    tree = _concat([dense, scenes])
    acts = np.concatenate(
        [np.random.RandomState(12).randint(0, 17, (3, 8)),
         np.concatenate([scene_acts, scene_acts[:1]])], 1).astype(np.int32)
    step = jax.jit(jax.vmap(lambda s, a: jstep.step(s, a, jcfg, False)))
    js = _to_jax(tree)
    mine = convert.state_from_numpy(tree, 'cpu')
    for t in range(3):
      js, jout = step(js, jnp.asarray(acts[t]))
      mine, out = step_batch(mine, torch.from_numpy(acts[t]), CFG,
                                      balance=False)
      _assert_same(convert.to_numpy(mine), _to_numpy(js), f'tick {t}')
      _assert_same(convert.to_numpy(out), _to_numpy(jout), f'out {t}')
    # The cap bit: dense players started with health up to 9.
    assert int(tree['player']['inventory'][:, H].max()) > 5
    assert int(mine.player.inventory[:, H].max()) <= 5
  finally:
    jrules.override_rules(lambda r: None)
    rules.override_rules(lambda r: None)
  assert _cached_health_max() == (9, 9)
  assert int(jrules.TABLES.item_max[jrules.ITEM_HEALTH]) == 9
