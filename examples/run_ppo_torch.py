"""PPO on Crafter with the port (the counterpart of ``examples/run_ppo.py``;
reference: examples/run_ppo.py:1-21).

The whole actor-learner loop runs on the GPU (``crafter_tpu_torch/ppo.py``);
this thin example mirrors the reference's scale (1M env steps) and passes
any further arguments on to ``crafter_tpu_torch.run_train``:

    python examples/run_ppo_torch.py
    python examples/run_ppo_torch.py --device cpu --steps 32 --num_envs 4 \\
        --rollout 4
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from crafter_tpu_torch import run_train  # noqa: E402


def main(argv=()):
  run_train.main(['--steps', '1000000', '--outdir', 'logdir/ppo', *argv])


if __name__ == '__main__':
  main(sys.argv[1:])
