"""The port's multi-process path, for real: two OS processes over a TCP
coordinator on the CPU (gloo).

The counterpart of ``tests/test_distributed.py``.  Both tools run as two
ranks side by side: ``tools/dist_worker_cuda.py`` (a sharded ``VecEnv``
stepped in lockstep, stats all-reduced; it prints ``DIST OK``) and
``tools/demo_64k_cuda.py``, the config-4 runner (sharded group steps, the
stats all-reduce; one JSON record a rank).  Every process has a timeout.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest

from one_thread import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOOLS = ROOT / 'tools'
NPROC = 2
TIMEOUT = 300


def _free_port() -> int:
  with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    return s.getsockname()[1]


def _start(argv_of_rank):
  env = dict(os.environ, OMP_NUM_THREADS='1')
  return [subprocess.Popen([sys.executable] + argv_of_rank(pid),
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True, env=env, cwd=str(ROOT))
          for pid in range(NPROC)]


def _finish(procs, what):
  outs = []
  try:
    for p in procs:
      outs.append(p.communicate(timeout=TIMEOUT)[0])
  except subprocess.TimeoutExpired:
    pytest.fail(f'{what} timed out\n' + '\n'.join(outs))
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.communicate()
  for pid, (p, out) in enumerate(zip(procs, outs)):
    assert p.returncode == 0, f'{what} rank {pid} failed:\n{out[-3000:]}'
  return outs


@pytest.fixture(scope='module')
def both_tools():
  """Both tools' two ranks, all four processes side by side."""
  worker_port, demo_port = _free_port(), _free_port()
  workers = _start(lambda pid: [
      str(TOOLS / 'dist_worker_cuda.py'), str(pid), str(NPROC),
      str(worker_port), '--device', 'cpu'])
  demos = _start(lambda pid: [
      str(TOOLS / 'demo_64k_cuda.py'), '--device', 'cpu', '--num_envs', '64',
      '--steps', '20', '--coordinator', f'127.0.0.1:{demo_port}',
      '--num_processes', str(NPROC), '--process_id', str(pid)])
  return _finish(workers, 'dist_worker_cuda'), _finish(demos, 'demo_64k_cuda')


def test_two_process_cluster_steps_sharded_envs(both_tools):
  for pid, out in enumerate(both_tools[0]):
    assert f'DIST OK process={pid}/{NPROC}' in out, out[-3000:]
    assert 'backend=gloo' in out and 'envs=8' in out, out[-3000:]


def test_demo64k_cuda_coordinator_two_processes(both_tools):
  recs = []
  for pid, out in enumerate(both_tools[1]):
    lines = [json.loads(line) for line in out.splitlines()
             if line.startswith('{')]
    assert len(lines) == 1, f'rank {pid} records:\n{out[-3000:]}'
    recs.append(lines[0])
  for pid, rec in enumerate(recs):
    assert rec['processes'] == NPROC and rec['devices'] == NPROC, rec
    assert rec['num_envs'] == 64 and rec['steps'] == 20, rec
    assert rec['value'] > 0 and rec['rank'] == pid, rec
    assert rec['backend'] == 'gloo' and rec['card'] is None, rec
  # The stats all-reduce gives every rank the same totals.
  assert recs[0]['episodes_done'] == recs[1]['episodes_done']
