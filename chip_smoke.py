"""Smoke test of the PyTorch/CUDA port on one GPU: build, check, drive.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

1. Builds the CUDA kernels of ``crafter_tpu_torch/csrc`` (nvcc, sm_90a),
   prints each kernel's registers and spills, and the resident blocks per
   SM and shared memory a block of the group and tick kernels at 64x64 and
   at 48x48, of the balance kernel at 64x64 with 12x12 and 5x7 chunks, and
   of the render kernel's two instantiations at 64x64 and of its global one
   at 512x512, and of the threefry kernel's output modes (the occupancy
   calculator).
2. Holds each kernel against its plain PyTorch twin on the card, on the
   same inputs at main-path shapes: the group tick (without and with render
   snapshots), the tick and the balance at 4096 envs (states reached by
   stepping fresh worlds); the group tick (K = 10, without and with
   snapshots) and the tick again on states packed with entities
   (``tests/dense_states.py``) at 4096 envs, on 1024 such states of a 48x48
   world (the kernels' generic instantiation) and on the hand-built scenes
   of the CPU tests, requiring skeletons to shoot, arrows to hit and
   zombies to strike in the dense ticks; the balance also on dense states
   with steps past 10000 at a day length of 200 and a third of the worlds
   all grass, at 4096 envs with 12x12 and 5x7 chunks and on 1024 envs of a
   48x40 world (the kernel's generic loads); the 2-D noise in its shared form
   (the channels' points once, a seed a world and channel) and its
   per-point form at 320, 512 and 32 worlds (a reset pass, a chunk of
   ``vec_reset_chunked``, the per-tick reset pass), the worlds made from it
   equal to the per-point twin's and, at 320 and 32, to the CPU's; the
   render kernel on 40960 frames (one pixel group's) in both output
   formats and both instantiations (tables in shared memory or read from
   global memory), on 4096 frames (the per-tick paths' batch), with a
   share of the frames at night, a share sleeping and some players at the
   map's edge, and at 512x512 (the global instantiation), and the daylight
   kernel on those frames' steps against its plain form; the threefry
   kernel on the draws of a reset pass (fold_in by int32 data and by an
   int, the splits, randint's bit draws, both uniform planes) at 320 and
   5,120 keys against its int64 twin run on the card, one launch a draw;
   the 3-D noise on the 3-D form of that reset pass's points (each
   channel's z as the third coordinate) and the roll micro-bench
   kernel on (40960, 4096) int32 rows, all three kinds at 10 and 40 stages
   (each kind's blocks per SM, shared memory a block and ring depth
   printed), its 'roll' kind at 10 stages timed over ROLL_REPEATS repeats by
   events and by the profiler against its bound.
   Integer outputs, rewards and frame bytes must be bitwise equal; noise
   must be bitwise equal or within NOISE_ATOL (the count of differing
   points is printed), with no material of the 320 worlds flipped.
3. Drives the paths at 4096 envs, each with the launch counts set to
   0 just before and read just after, and prints env-steps/s (CUDA events):
   the state-only path (``vec_reset_chunked``, then groups of
   ``vec_step_group``, K = 10 ticks, ``reset_batch = 320``) and the pixel
   path (groups of ``vec_step_group_obs``, one frame per tick and env) in
   two turns each, alternating, the per-tick path (``VecEnv.reset`` and
   ``step``), and the training path: ``PPO.init`` and three
   ``train_step_with_stats`` (one warm-up, two timed) of the full NatureCNN
   policy on 4096 envs x 64 ticks, 3 epochs of 8 minibatches.  Every env
   must have stepped the full count or reset, every frame batch is read,
   every kernel of a path must have been launched on it, and training must
   count its updates and steps, keep every metric finite and change every
   layer's parameters.  The two kernels that no entry point of the package
   reaches are driven through what their users call: ``noise_cuda.noise3``
   itself and ``tools/bench_roll_cuda.py``.  Then the port's bench,
   ``bench_cuda.py`` at its defaults (its JSON line printed, every env
   stepped or reset in each repeat, its kernels launched).  The worlds of
   one reset pass are made on the CPU too, and every leaf must equal the
   card's.
4. Runs the kernel path on the card and the CPU path (the plain twins) at
   13 envs across episode ends and requires every leaf and frame equal:
   3 groups state-only, 3 groups of the pixel path, 30 ticks of ``VecEnv``
   (card and CPU), and ``Env`` over two episodes of 30 ticks with a render
   at 512x512 (card and CPU); ``daylight`` on the card (its kernel) must
   equal the CPU's for steps 0..20000 at day lengths 200 and 300; the policy's
   forward on the card must agree with the CPU's within POLICY_ATOL; and a
   training state saved on the card, restored and stepped must equal the
   one stepped without the round trip.
5. Drives what the port adds beyond the batched paths, each with the
   launch counts set to 0 just before and read just after:
   C1, the 'compat' worldgen mode (the permutation-table OpenSimplex, its
   candidate sum one launch of ``csrc/noise3_perm.cu`` a ``generate_world``
   call): the kernel against its twin ``noise3_total`` at 320 worlds (bit
   for bit), timed with the wrapper and alone against its bound (a row of
   the kernel table); 320 worlds on the card equal to the CPU's, and
   through the kernel; ``vec_reset_chunked`` of 4096 compat envs,
   the reset pass of 320 worlds timed in compat and in auto mode in turns
   and profiled (device busy, operations a pass), 3 state-only groups on
   the compat worlds (group tick and balance kernels, no 2-D noise), and
   13 envs over 3 groups on the card equal to the plain path on the CPU
   across episode ends; C2, ``ParityEnv``'s seeded rollout
   (``tests/parity_digest.py``) with the digest the CPU tests pin to the
   JAX package's, and its steps/s; C3, the CLIs: ``run_terrain`` at its
   defaults (4 worlds viewed whole at 1024x1024: the render kernel on
   windows of 4048 values) equal to the plain twin's image on the CPU, its
   PNG inflating to it, and the kernel on that window timed against the
   twin; ``run_random --envs 4096 --steps 409600`` (its env-steps/s) and
   ``run_random`` on one env for 200 steps with ``--record``.
6. Drives the multi-device layer (``crafter_tpu_torch.parallel``), each
   phase with its launches counted from 0 after its set-up (the initial
   reset, ``init``, the demo's warm-up), in the ranks' own processes for
   the ranks started as subprocesses: D1, one NCCL rank in this process: the
   sharded group step on 4096 envs over 3 groups equal to
   ``vec_step_group``, ``psum_stats`` through NCCL, and the sharded
   ``VecEnv`` over 30 ticks equal to ``VecEnv`` (obs, reward, done, info);
   D2, two gloo ranks on the one card (NCCL refuses two ranks on one GPU):
   4096 envs, 2048 a rank, 3 groups whose per-rank reset budget overflows,
   the gathered leaves equal to ``vec_step_group`` run on each half with the
   rank's budget; D3, ``tools/demo_64k_cuda.py --num_envs 65536`` as one
   NCCL rank and as two gloo ranks (both records printed; every env stepped
   or reset); D4, ``make_sharded_train`` on two gloo ranks at the training
   path's sizes, 2 updates (each split into rollout and learn; the rate is
   the second's) with finite metrics equal on both ranks and
   parameters bitwise equal across ranks after each, every layer changed,
   and a 64-env rollout of 8 ticks under deterministic algorithms equal to
   the one-process ``PPO``'s.  Rates of ranks sharing one card are printed,
   not compared.  Prints the phase's results as one JSON line.
7. Drives the tools layer, each tool through its ``main`` as a user runs
   it, each counting its own launches from 0 after its set-up: E1,
   ``tools/random_baseline_cuda.py --steps 1000000 --envs 512`` (its score
   beside RESULTS.md's TPU figure as context, the success rates, the rate;
   tick, balance and noise2 launched), then its first two chunks on the
   CPU through the plain path, whose ``stats.jsonl`` lines must equal the
   card's first lines; E2, ``tools/score_run_cuda.py`` on E1's logdir, the
   same score; E3, ``tools/bench_ppo_cuda.py --updates 2``; E4,
   ``tools/ppo_budget_cuda.py --reps 1`` (the stage table; the env stages,
   the rollout and the full update launch their kernels); E5,
   ``tools/profile_summary_cuda.py --iters 20`` per tick, ``--group`` and
   ``--render`` and ``tools/profile_learn_cuda.py --stage learn``, each
   table with device ops and each path's kernels launched.
8. Drives the JAX package's last measuring tools, each through its
   ``main`` (or its command line) as a user runs it, the launch counts set
   to 0 just before each: M1, ``tools/bench_obs_shuffle_cuda.py`` at its
   defaults (262144 frames, 8 minibatches; every case's sum equal to
   ``nhwc``'s); M2, ``tools/bench_unpack_cuda.py 40960`` (U0 == U1, and
   the render kernel's three output formats equal byte for byte on real
   windows; the render launched); M3, ``tools/sweep_group_block_cuda.py``
   at its defaults (four geometries of the group kernel, each a build of
   its own, every one's states, rewards and occupancy equal to the
   shipped build's; each variant's registers, spills and blocks an SM
   printed; the group kernel launched); M4, ``bench_cuda.py --sizes 4096
   2048`` as a subprocess (exit 0, a record with ``value`` > 0, its
   children's state-only and pixel kernels launched).  Prints the phase's
   record as one JSON line.

Every kernel's time is taken with the wrapper (CUDA events) and on the
device alone (``torch.profiler``); the balance also prints the host's
share of its time with the wrapper.  Prints the kernel table as one JSON
line, one row per kernel and main-path shape, then the card's name and
power limit, then ``{"ok": true, "device": {...}}`` as the last line.  Any
failed phase raises, so the script exits non-zero and prints no result.
"""

import json
import math
import os
import re
import runpy
import subprocess
import sys
import tempfile
import time
from pathlib import Path

N_ENVS = 4096
RESET_BATCH = 320          # min(N, 10 * max(32, N // 128)), bench.py:57-58
WARM_GROUPS = 3            # groups stepped before the kernel checks
MAIN_GROUPS = 10           # timed groups of the state-only path, per turn
PIXEL_GROUPS = 10          # timed groups of the pixel path, per turn
TICKS = 20                 # timed VecEnv.step calls of the per-tick path
PROFILE_GROUPS = 3         # groups under torch.profiler for the breakdown
TWIN_CHUNK = 4096          # frames per call of the render kernel's twin
RENDER_BIG = (512, 512)    # a render size whose tables do not fit in shared
RENDER_BIG_FRAMES = 64     # memory: the kernel's global instantiation
NOISE_WORLDS = (320, 512, 32)   # reset pass, vec_reset_chunked, per tick
THREEFRY_WORLDS = (320, 5120)   # keys of the threefry check: the 4096 and
                                # the 65,536-env reset passes
TOP_OPS = 8
NOISE_ATOL = 1e-6          # noise may differ from its twin by at most this
ROLL_ROWS = 40960          # rows of the roll micro-bench (tools/bench_roll.py)
ROLL_REPEATS = 5           # repeats of its timing against the bound
# The balance kernel's checks beyond the group's states: (area, chunk size,
# envs) of dense states at a day length of 200; 48x40 takes the generic
# loads (a height that is no multiple of 16).
BALANCE_CASES = (((64, 64), (12, 12), 4096), ((64, 64), (5, 7), 4096),
                 ((48, 40), (12, 12), 1024))
# The tick kernels' generic instantiation is checked on this area.
DENSE_AREA, DENSE_AREA_ENVS = (48, 48), 1024
# The training path: the sizes of tools/bench_ppo.py.
PPO_ENVS, PPO_ROLLOUT, PPO_RESET = 4096, 64, 32
PPO_EPOCHS, PPO_MINIBATCHES = 3, 8
# bfloat16 keeps 8 bits of mantissa and the card and the CPU sum in another
# order: logits and values of order 1 may differ by this much.
POLICY_ATOL = 2e-2
# H100 SXM peaks from NVIDIA's data sheet: memory rate, and the CUDA-core
# float32 rate, which the bound also applies to integer operations (a lower
# bound on their time: the int32 units are no faster).
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
# Operations the work needs per element, counted from the kernels' source
# where they do that work.  The mob phase of a tick is needed only for the
# active entities (etype > player within the update distance): two
# cell_bits hashes (~44), the move decision and target read (~60), the
# claim word, its resolution at the target and the move (~50), shooting,
# strikes and removals (~30); the kernel's own dense sweep over every cell
# is not work the function needs.  The player phase costs ~300 a tick per
# env.  The balance needs ~4 a cell to sort it into its chunk's counts;
# the 2-D noise ~170 a point (csrc/noise2.cu:noise_at: 8 candidates of 12
# float operations, 6 integer ones and a table load, ~26 for the base
# corner).
# Every rendered pixel needs its texel (~30: three indexed loads, the
# three-channel blit, packing); a pixel of the lit view also the lighting
# (~75: two lumas, desaturate, tint, daylight blend, sleep overlay, floors);
# and of those the pixels of a night frame the keyed noise (~25: hash,
# scale, mask, blend, floors).  By day the noise does not reach the frame.
OPS_TICK_ACTIVE = 180
OPS_TICK_PLAYER = 300
OPS_BALANCE_CELL = 4
OPS_NOISE_POINT = 170
# The 3-D noise (csrc/noise3.cu:candidates, an FMA counted as two): the
# base cell, its float sums, four squish products and the hash products
# ~58; the coordinate differences 72 (36 distinct, shared by candidates
# with equal offsets); the attenuations 154, their fourth powers 52; the
# hashes 286 (xor of the three products, mix, shift, xor, mask, modulo 24,
# index); the gradient dot products 130 and the sum 50.
OPS_NOISE3_POINT = 800
# The compat mode's permutation-table noise (csrc/noise3_perm.cu), counted
# from the algorithm and not from the kernel (an FMA counted as two, a
# table lookup as one): what is a function of the point alone once a point
# (the stretch 17; per candidate its lattice cell 3, the squish 4, the
# offsets 9, the attenuation 7 and its fourth power 2, the table's low
# bytes 3: 28 x 26), and per (point, world, candidate) what the table
# decides: three lookups, gy * dy and three FMAs.
OPS_NOISE3_PERM_POINT = 745
OPS_NOISE3_PERM_TRIPLE = 10
OPS_RENDER_TEXEL = 30
OPS_RENDER_LIGHT = 75
OPS_RENDER_NOISE = 25
# Phase 6, multi-device: 4096 envs, an episode cap that ends every episode
# in the third group (so that a reset budget overflows), and the demo at
# config 4's width.
D_LENGTH, D_SEED, D_GROUPS = 25, 17, 3
D_VECENV_TICKS = 30
DEMO_ENVS, DEMO_STEPS = 65536, 100
D_SMALL_ENVS, D_SMALL_TICKS = 64, 8
RANK_TIMEOUT = 420          # seconds a subprocess rank may take
# Phase 7: the random baseline's defaults; on the CPU the steps that make
# its first two chunks of 64 ticks (target = steps + steps // 8).
E1_STEPS, E1_ENVS = 1_000_000, 512
E1_CPU_STEPS = 40_000
# Phase 8: the unpack tool at its JAX counterpart's frame count, and the
# bench's size fallback on bench.py's first two sizes.
M2_FRAMES = 40960
M4_SIZES = (4096, 2048)
M4_TIMEOUT = 600            # seconds the bench's subprocess may take


def fail(msg):
  raise SystemExit(f'chip_smoke: FAILED: {msg}')


def kernel_name(mangled):
  """The name of a kernel, with its height instantiation, out of its
  mangled name: the last length-prefixed identifier that ends in
  'kernel' (a namespace's hash may hold digits too)."""
  name = mangled
  for m in re.finditer(r'(?=(\d+))', mangled):
    end = m.start() + len(m.group(1))
    ident = mangled[end:end + int(m.group(1))]
    if ident.endswith('kernel'):
      height = re.match(r'ILi(\d+)E', mangled[end + len(ident):])
      name = ident + (f'<{height.group(1)}>' if height else '')
  return name


def free_port():
  import socket
  with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    return s.getsockname()[1]


def np_rows(tree, rows, axis=0):
  """``rows`` along ``axis`` of every array of nested dicts of numpy arrays
  (``to_numpy`` of a state); arrays with no such axis are kept."""
  if isinstance(tree, dict):
    return {name: np_rows(v, rows, axis) for name, v in tree.items()}
  return tree if tree.ndim <= axis else tree[(slice(None),) * axis + (rows,)]


def np_diffs(a, b, path=''):
  """The paths where two nested dicts of numpy arrays differ in shape,
  dtype or any bit."""
  if isinstance(a, dict):
    return [p for name in a for p in np_diffs(a[name], b[name],
                                              f'{path}.{name}')]
  same = (a.shape == b.shape and a.dtype == b.dtype
          and a.tobytes() == b.tobytes())
  return [] if same else [path]


def d_actions(prng, group, k, n, dev, rows=None):
  """Group ``group``'s (K, N) actions of phase 6, or a rank's columns of
  them (``rows``: its slice of the N envs)."""
  key = prng.fold_in(prng.key(D_SEED, dev), group)
  if rows is None:
    return prng.randint(key, 0, 17, (k, n))
  return prng.randint(key, 0, 17, (k, rows.stop - rows.start),
                      rows=(rows.start, n), axis=1)


def rank_group(ct, mesh):
  """D2 on one rank: 3 sharded groups of 4096 envs; rank 0 then holds the
  gathered leaves against ``vec_step_group`` on each half with the rank's
  budget (ranks are independent, so the comparison is exact)."""
  import torch
  from crafter_tpu_torch.parallel import mesh as mesh_lib
  from crafter_tpu_torch.utils import launches, zero_launches
  n, dev = 4096, mesh.device
  cfg = ct.EnvConfig(reward=False, length=D_LENGTH)
  k = cfg.balance_every
  rows = mesh.rows(n)
  vs = ct.vec_reset_chunked(ct.home_keys(D_SEED, n, dev)[rows], cfg)
  step = mesh_lib.make_sharded_group_step(mesh, cfg, RESET_BATCH)
  zero_launches()     # count the sharded groups' launches only
  outs = []
  for g in range(D_GROUPS):
    vs, out = step(vs, d_actions(ct.prng, g, k, n, dev, rows))
    outs.append(out)
  torch.cuda.synchronize()
  res = dict(launches=launches(), pending=int(vs.pending.sum()))
  got = mesh_lib.gather_batch(vs, mesh, n)
  got_outs = [mesh_lib.gather_batch(o, mesh, n, axis=1) for o in outs]
  if mesh.rank == 0:
    got, got_outs = ct.to_numpy(got), [ct.to_numpy(o) for o in got_outs]
    rb_local = -(-RESET_BATCH // mesh.size)
    diffs = []
    for r in range(mesh.size):
      part = slice(r * n // mesh.size, (r + 1) * n // mesh.size)
      ref = ct.vec_reset_chunked(ct.home_keys(D_SEED, n, dev)[part], cfg)
      for g in range(D_GROUPS):
        ref, out = ct.vec_step_group(
            ref, d_actions(ct.prng, g, k, n, dev)[:, part], cfg, rb_local)
        diffs += np_diffs(np_rows(got_outs[g], part, 1), ct.to_numpy(out),
                          f'rank {r} group {g} outs')
      diffs += np_diffs(np_rows(got, part), ct.to_numpy(ref),
                        f'rank {r} final')
    res.update(diffs=diffs, episodes=int(got['episode'].sum()))
  return res


def rank_train(ct, mesh):
  """D4 on one rank: ``make_sharded_train`` at the training path's sizes,
  two updates; then a rollout of 64 envs over 8 ticks under deterministic
  algorithms, which rank 0 holds against the one-process ``PPO``'s."""
  import hashlib
  import torch
  from crafter_tpu_torch.parallel import mesh as mesh_lib
  from crafter_tpu_torch.utils import launches, zero_launches
  dev = mesh.device
  cfg = ct.PPOConfig(num_envs=PPO_ENVS, rollout_len=PPO_ROLLOUT,
                     epochs=PPO_EPOCHS, minibatches=PPO_MINIBATCHES,
                     reset_batch=PPO_RESET)
  ppo, init, train_step, _ = ct.make_sharded_train(ct.EnvConfig(), cfg,
                                                   mesh)
  # The split of an update: the time where the rollout hands over to the
  # learner.
  handover = []
  learn = ppo._learn

  def marked_learn(*args):
    torch.cuda.synchronize()
    handover.append(time.perf_counter())
    return learn(*args)

  ppo._learn = marked_learn
  # The learner's gradient all-reduces, timed on the host's clock.
  grad_sum_s = []
  sum_grads = ppo._sum_grads

  def timed_sum_grads(policy):
    torch.cuda.synchronize()
    t = time.perf_counter()
    sum_grads(policy)
    torch.cuda.synchronize()
    grad_sum_s.append(time.perf_counter() - t)

  ppo._sum_grads = timed_sum_grads
  ts = init(ct.prng.key(0, dev))
  zero_launches()     # count the two updates' launches only
  params0 = {name: q.detach().clone()
             for name, q in ts.params.named_parameters()}
  updates = []
  for _ in range(2):
    grad_sum_s.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, metrics = train_step(ts)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    flat = torch.cat([q.detach().reshape(-1) for q in ts.params.parameters()])
    updates.append(dict(
        ms=(t1 - t0) * 1e3, rollout_ms=(handover[-1] - t0) * 1e3,
        learn_ms=(t1 - handover[-1]) * 1e3,
        grad_sum_ms=sum(grad_sum_s) * 1e3, grad_sums=len(grad_sum_s),
        metrics={name: float(v) for name, v in metrics.items()},
        params=hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()))
  unchanged = [
      layer for layer in ('conv1', 'conv2', 'conv3', 'dense', 'logits',
                          'value')
      if all(torch.equal(q.detach(), params0[name])
             for name, q in ts.params.named_parameters()
             if name.startswith(layer + '.'))]
  res = dict(launches=launches(), updates=updates, unchanged=unchanged,
             update=ts.update, env_steps=ts.env_steps,
             local_envs=int(ts.obs.shape[0]))
  del ts, params0
  torch.cuda.empty_cache()
  torch.use_deterministic_algorithms(True, warn_only=True)
  env_cfg = ct.EnvConfig(length=5)       # every episode ends in the rollout
  small = ct.PPOConfig(num_envs=D_SMALL_ENVS, rollout_len=D_SMALL_TICKS,
                       epochs=1, minibatches=2, reset_batch=8,
                       time_minibatch=True)
  _, init, train_step, _ = ct.make_sharded_train(env_cfg, small, mesh)
  ts, metrics = train_step(init(ct.prng.key(1, dev)))
  got = ct.to_numpy(mesh_lib.gather_batch(dict(vec=ts.vec, obs=ts.obs), mesh,
                                          D_SMALL_ENVS))
  if mesh.rank == 0:
    one = ct.PPO(env_cfg, small, device=dev)
    ts1, metrics1 = one.train_step(one.init(ct.prng.key(1, dev)))
    res['small'] = dict(
        diffs=np_diffs(got, ct.to_numpy(dict(vec=ts1.vec, obs=ts1.obs))),
        episodes_done=int(metrics['episodes_done']),
        episodes_done_one=int(metrics1['episodes_done']))
  torch.use_deterministic_algorithms(False)
  return res


def rank_main(argv):
  """One rank of phase 6 in a process of its own, on the one card through
  gloo: ``chip_smoke.py --rank {group|train} RANK WORLD PORT``.  Prints its
  results as one line ``RESULT {...}``."""
  os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
  phase, rank, world, port = argv[0], int(argv[1]), int(argv[2]), argv[3]
  import torch.distributed as dist
  sys.path.insert(0, str(Path(__file__).resolve().parent))
  import crafter_tpu_torch as ct
  from crafter_tpu_torch.parallel import mesh as mesh_lib
  mesh_lib.distributed_init(f'127.0.0.1:{port}', world, rank, backend='gloo',
                            device='cuda')
  mesh = mesh_lib.dp_mesh()
  res = {'group': rank_group, 'train': rank_train}[phase](ct, mesh)
  dist.barrier()
  dist.destroy_process_group()
  print('RESULT ' + json.dumps(res), flush=True)


def phase7(root, card, need_launches):
  """Phase 7: the tools layer (E1-E5), each tool driven through its
  ``main`` as a user runs it, its launches counted by the tool itself from
  0 after its set-up.  Returns the phase's record."""
  import contextlib
  import io
  import torch
  p_start = time.perf_counter()
  tools = root / 'tools'
  run = lambda name, argv: runpy.run_path(
      str(tools / f'{name}.py'), run_name=name)['main'](argv)
  env_kernels = ('tick', 'balance', 'noise2', 'threefry')
  pixel_kernels = env_kernels + ('render_win79', 'daylight')
  rec = {}
  cwd = os.getcwd()
  with tempfile.TemporaryDirectory() as tmp:
    # The score tools write scores/ under the working directory.
    os.chdir(tmp)
    try:
      # E1: the random baseline at its defaults, then its first chunks on
      # the CPU through the plain path.
      t0 = time.perf_counter()
      e1 = run('random_baseline_cuda', [
          '--steps', str(E1_STEPS), '--envs', str(E1_ENVS), '--outdir',
          f'{tmp}/random'])
      need_launches('E1 random baseline', e1['launches'], env_kernels)
      if e1['score'] is None or not 0 < e1['score'] < 100 \
          or e1['env_steps'] < E1_STEPS + E1_STEPS // 8:
        fail(f'E1: record {e1}')
      print(f'E1 random_baseline_cuda.py --steps {E1_STEPS} --envs {E1_ENVS} '
            f'on {card}: crafter score {e1["score"]:.4f} % over '
            f'{e1["episodes"]} episodes ({e1["env_steps_per_s"]:,.0f} '
            f'env-steps/s, {e1["seconds"]:.1f} s; launches '
            f'{e1["launches"]}); for context, not a gate: RESULTS.md has '
            f'1.51 % for the JAX package on a TPU v5e (round 4\'s engine); '
            f'success rates %: {e1["success_rates"]}', flush=True)
      t1 = time.perf_counter()
      e1_cpu = run('random_baseline_cuda', [
          '--steps', str(E1_CPU_STEPS), '--envs', str(E1_ENVS), '--outdir',
          f'{tmp}/random_cpu', '--device', 'cpu'])
      chunks = -(-e1_cpu['env_steps'] // (E1_ENVS * 64))
      card_lines = Path(tmp, 'random', 'stats.jsonl').read_text().splitlines()
      cpu_lines = Path(tmp, 'random_cpu',
                       'stats.jsonl').read_text().splitlines()
      if chunks != 2 or not cpu_lines \
          or card_lines[:len(cpu_lines)] != cpu_lines:
        fail(f'E1: the CPU\'s {len(cpu_lines)} stats.jsonl lines of '
             f'{chunks} chunks differ from the card\'s first lines')
      print(f'E1 on the CPU, the first {chunks} chunks ({e1_cpu["env_steps"]} '
            f'env steps): its {len(cpu_lines)} stats.jsonl lines == the '
            f'card\'s first {len(cpu_lines)} ({time.perf_counter() - t1:.1f} '
            's)', flush=True)
      rec['e1'] = dict(record=e1, cpu_lines=len(cpu_lines), cpu_chunks=chunks,
                       seconds=time.perf_counter() - t0)

      # E2: the score tool on E1's logdir.
      out = io.StringIO()
      with contextlib.redirect_stdout(out):
        run('score_run_cuda', [f'{tmp}/random', 'crafter_noreward', 'random',
                               str(E1_STEPS)])
      print(out.getvalue(), end='', flush=True)
      m = re.search(r'^random: crafter score ([0-9.]+) ', out.getvalue(), re.M)
      if not m or m.group(1) != f'{e1["score"]:.2f}':
        fail(f'E2: score_run_cuda.py printed {m and m.group(1)}, E1 '
             f'{e1["score"]:.2f}')
      print(f'E2 score_run_cuda.py on E1\'s logdir: {m.group(1)} % == E1\'s',
            flush=True)
      rec['e2'] = dict(score=float(m.group(1)))
    finally:
      os.chdir(cwd)
    torch.cuda.empty_cache()

    # E3: the PPO bench, two timed updates at its defaults.
    e3 = run('bench_ppo_cuda', ['--updates', '2'])
    need_launches('E3 bench_ppo_cuda', e3['launches'], pixel_kernels)
    if not e3['value'] > 0 or len(e3['update_ms']) != 2:
      fail(f'E3: record {e3}')
    print(f'E3 bench_ppo_cuda.py --updates 2 on {card}: {e3["value"]:,} '
          f'env-steps/s, update ms {e3["update_ms"]} (rollout '
          f'{e3["rollout_ms"]}, learn {e3["learn_ms"]}), first update '
          f'{e3["compile_s"]} s; launches {e3["launches"]}', flush=True)
    rec['e3'] = e3
    torch.cuda.empty_cache()

    # E4: the PPO stage budget, one rep at its defaults.
    e4 = run('ppo_budget_cuda', ['--reps', '1'])
    for stage, needed in (('env_only', env_kernels),
                          ('env_render', pixel_kernels),
                          ('rollout', pixel_kernels), ('full', pixel_kernels)):
      need_launches(f'E4 ppo_budget_cuda {stage}', e4['launches'][stage],
                    needed)
    print(f'E4 ppo_budget_cuda.py --reps 1 on {card}: full '
          f'{e4["full_steps_per_s"]:,} env-steps/s; launches by stage '
          f'{e4["launches"]}', flush=True)
    rec['e4'] = e4
    torch.cuda.empty_cache()

    # E5: the profile tables.
    rec['e5'] = {}
    for mode, needed in (('tick', env_kernels),
                         ('group', ('group_tick', 'balance', 'noise2',
                                    'threefry')),
                         ('render', ('group_tick', 'balance', 'noise2',
                                     'threefry', 'render_win79',
                                     'daylight'))):
      print(f'E5 profile_summary_cuda.py --iters 20 '
            f'{"" if mode == "tick" else "--" + mode} on {card}:', flush=True)
      e5 = run('profile_summary_cuda', [
          '--iters', '20', '--logdir', f'{tmp}/profile_{mode}']
          + ([] if mode == 'tick' else [f'--{mode}']))
      need_launches(f'E5 profile_summary_cuda {mode}', e5['launches'],
                    needed)
      if not e5['top']:
        fail(f'E5 profile_summary_cuda {mode}: no device op recorded')
      rec['e5'][mode] = e5
    print(f'E5 profile_learn_cuda.py --stage learn on {card}:', flush=True)
    e5 = run('profile_learn_cuda', ['--stage', 'learn', '--logdir',
                                    f'{tmp}/profile_learn'])
    if not e5['top']:
      fail('E5 profile_learn_cuda: no device op recorded')
    rec['e5']['learn'] = e5
    torch.cuda.empty_cache()
  rec['seconds'] = time.perf_counter() - p_start
  print(f'phase 7 (tools) on {card}: {rec["seconds"]:.1f} s', flush=True)
  return rec


def phase8(root, card, need_launches):
  """Phase 8: the measuring tools (M1-M4), each driven as a user runs it,
  the launch counts set to 0 just before each and read just after.
  Returns the phase's record."""
  import torch
  from crafter_tpu_torch.utils import launches, zero_launches
  p_start = time.perf_counter()
  tools = root / 'tools'
  run = lambda name, argv: runpy.run_path(
      str(tools / f'{name}.py'), run_name=name)['main'](argv)
  rec = {}
  torch.cuda.empty_cache()

  # M1: the obs gather layouts; the tool stops on a failed consumption
  # check.
  t0 = time.perf_counter()
  m1 = run('bench_obs_shuffle_cuda', [])
  rec['m1'] = dict(ms=m1['ms'], bound_ms=m1['bound_ms'], sums=m1['sums'],
                   peak_bytes=m1['peak_bytes'],
                   seconds=time.perf_counter() - t0)
  print(f'M1 bench_obs_shuffle_cuda.py on {card}: ms {m1["ms"]}, peak '
        f'{m1["peak_bytes"] / 1e9:.2f} GB', flush=True)
  del m1
  torch.cuda.empty_cache()

  # M2: U0 / U1, and the render kernel's three formats against each other.
  t0 = time.perf_counter()
  zero_launches()
  m2 = run('bench_unpack_cuda', [str(M2_FRAMES)])
  m2_counts = launches()
  need_launches('M2 bench_unpack_cuda', m2_counts, ('render_win79',))
  rec['m2'] = dict(record=m2, launches=m2_counts,
                   seconds=time.perf_counter() - t0)
  print(f'M2 bench_unpack_cuda.py {M2_FRAMES} on {card}: loop ms '
        f'{m2["loop_ms"]}, render ms {m2["render_ms"]}, unpack ms '
        f'{m2["unpack_ms"]}; launches {m2_counts}', flush=True)
  torch.cuda.empty_cache()

  # M3: the group kernel's geometries; the tool stops on a variant that
  # differs from the shipped build or does not advance.
  t0 = time.perf_counter()
  zero_launches()
  m3 = run('sweep_group_block_cuda', [])
  m3_counts = launches()
  need_launches('M3 sweep_group_block_cuda', m3_counts, ('group_tick',))
  for label, entry in m3['variants'].items():
    if entry['registers'] is None or not entry['blocks_per_sm'] >= 1:
      fail(f'M3: geometry {label}: {entry}')
  rec['m3'] = dict(record=m3, launches=m3_counts,
                   seconds=time.perf_counter() - t0)
  print(f'M3 sweep_group_block_cuda.py on {card}: '
        + '; '.join(f'{label}: {e["ms_per_tick"]:.4f} ms/tick, '
                    f'{e["registers"]} registers, {e["spill_stores"]} B '
                    'spilled, '
                    f'{e["blocks_per_sm"]} blocks/SM'
                    for label, e in m3['variants'].items())
        + f'; launches {m3_counts}', flush=True)
  torch.cuda.empty_cache()

  # M4: the bench's size fallback, as its own process.
  t0 = time.perf_counter()
  out = subprocess.run(
      [sys.executable, str(root / 'bench_cuda.py'), '--sizes',
       *(str(n) for n in M4_SIZES)], capture_output=True, text=True,
      timeout=M4_TIMEOUT, cwd=root)
  for line in out.stderr.strip().splitlines()[-5:]:
    print(f'  bench_cuda.py --sizes: {line}')
  lines = out.stdout.strip().splitlines()
  print(f'M4 bench_cuda.py --sizes {" ".join(map(str, M4_SIZES))} on {card}: '
        f'exit {out.returncode}, {lines[-1] if lines else "no output"}',
        flush=True)
  if out.returncode != 0 or not lines:
    fail(f'M4: bench_cuda.py --sizes exited {out.returncode}')
  m4 = json.loads(lines[-1])
  if not (m4['value'] > 0 and m4.get('pixel_value', 0) > 0):
    fail(f'M4: record {m4}')
  need_launches('M4 bench --sizes, state-only', m4['launches']['state_only'],
                ('group_tick', 'balance', 'noise2', 'threefry'))
  need_launches('M4 bench --sizes, pixel', m4['launches']['pixel'],
                ('group_tick', 'balance', 'noise2', 'threefry',
                 'render_win79', 'daylight'))
  rec['m4'] = dict(record=m4, seconds=time.perf_counter() - t0)
  rec['seconds'] = time.perf_counter() - p_start
  print(json.dumps({'measuring_tools': rec}), flush=True)
  print(f'phase 8 (measuring tools) on {card}: {rec["seconds"]:.1f} s',
        flush=True)
  return rec


def main():
  # cuBLAS needs this to run deterministically (the checkpoint check of
  # phase 4 asks for deterministic algorithms); read when CUDA starts.
  os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
  import torch
  if not torch.cuda.is_available():
    fail('torch.cuda.is_available() is false: this smoke test needs a GPU')
  root = Path(__file__).resolve().parent
  if not (root / 'crafter_tpu_torch' / 'csrc').is_dir():
    fail(f'crafter_tpu_torch/csrc not found beside {Path(__file__).name}')
  sys.path.insert(0, str(root))

  import dataclasses
  import crafter_tpu_torch as ct
  from crafter_tpu_torch import _build, step as step_lib, step_cuda
  from crafter_tpu_torch import env as env_lib
  from crafter_tpu_torch import render as render_lib
  from crafter_tpu_torch import prng_cuda, render_cuda, worldgen
  from crafter_tpu_torch import checkpoint as ckpt_lib
  from crafter_tpu_torch import convert
  from crafter_tpu_torch.ops import noise, noise_cuda, roll_cuda
  from crafter_tpu_torch.state import leaves
  from crafter_tpu_torch.utils import card_line
  sys.path.insert(0, str(root / 'tests'))
  import dense_states

  dev = torch.device('cuda')
  card = card_line()
  print(f'card: {card}', flush=True)

  # 1. Build.
  t0 = time.perf_counter()
  lib_path = _build.build()
  _build.library()
  print(f'build: {time.perf_counter() - t0:.1f} s -> {lib_path}', flush=True)
  ptxas = (lib_path.parent / 'ptxas.log').read_text()
  for line in ptxas.splitlines():
    entry = re.search(r"entry function '(\w+)'", line)
    if entry:
      print(f'  kernel {kernel_name(entry.group(1))}')
    elif 'registers' in line or 'spill' in line or line.startswith('=='):
      print(f'  {line.strip()}')
  for area in ((64, 64), DENSE_AREA):
    for kernel in ('group', 'tick'):
      blocks, smem = step_cuda.occupancy(ct.EnvConfig(area=area), kernel)
      print(f'occupancy: {kernel} kernel at {area[0]}x{area[1]}: {blocks} '
            f'blocks of 256 threads per SM, {smem} bytes of shared memory '
            'a block', flush=True)
  for chunk in ((12, 12), (5, 7)):
    blocks, smem = step_cuda.balance_occupancy(ct.EnvConfig(chunk_size=chunk))
    print(f'occupancy: balance kernel at 64x64, {chunk[0]}x{chunk[1]} chunks: '
          f'{blocks} blocks of 256 threads per SM, {smem} bytes of shared '
          'memory a block', flush=True)
  cfg0 = ct.EnvConfig()
  for size, shared in (((64, 64), True), ((64, 64), False),
                       (RENDER_BIG, False)):
    big = ct.bake_atlas(size, cfg0.view, cfg0.item_rows, dev)
    blocks, smem = render_cuda.occupancy(big, shared)
    print(f'occupancy: render kernel at {size[0]}x{size[1]} '
          f'({"shared" if shared else "global"} tables): {blocks} blocks of '
          f'512 threads per SM, {smem} bytes of shared memory a block',
          flush=True)
    if blocks == 0:
      fail(f'the render kernel cannot run at {size}')
  for mode in ('split', 'bits', 'uniform'):
    print(f'occupancy: threefry kernel, {mode}: '
          f'{prng_cuda.occupancy(mode)} blocks of 256 threads per SM',
          flush=True)

  def timed(fn, reps):
    """``(result, ms)``: the median over ``reps`` calls after a warm-up, each
    call between its own events, so that a stall of the host (which shares
    its cores) between two calls is not counted as the kernel's time."""
    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(reps):
      spans.append([torch.cuda.Event(enable_timing=True) for _ in range(2)])
      spans[-1][0].record()
      out = fn()
      spans[-1][1].record()
    torch.cuda.synchronize()
    return out, sorted(t0.elapsed_time(t1) for t0, t1 in spans)[reps // 2]

  def device_ms(fn, kernel, reps=5):
    """The mean device time of one launch of the CUDA kernel named
    ``kernel`` over ``reps`` calls of ``fn`` (torch.profiler): the kernel
    alone, without the wrapper's packing and launch on the host.  The mean
    is over the launches the profiler recorded: it loses some at times,
    and where it recorded none in three tries the time is not measured
    (None)."""
    for _ in range(3):
      fn()
      torch.cuda.synchronize()
      with torch.profiler.profile(activities=[
          torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
          fn()
        torch.cuda.synchronize()
      events = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.key]
      launches = sum(e.count for e in events)
      if launches:
        return sum(e.self_device_time_total for e in events) / 1e3 / launches
    print(f'  the profiler recorded no launch of {kernel} in three tries')
    return None

  def dev_str(t):
    return 'not measured' if t is None else f'{t:.4f} ms'

  def host_share(ms, dev_ms):
    """The share of a call's time (with the wrapper) beyond the kernel's."""
    return 'not measured' if dev_ms is None else f'{1 - dev_ms / ms:.1%}'

  def max_err(a, b, what):
    """Max |a - b| over matching leaves (dataclasses, dicts or tensors);
    raises if shapes or dtypes differ."""
    as_leaves = lambda o: (sorted(o.items()) if isinstance(o, dict)
                           else leaves(o))
    worst = 0.0
    for (pa, x), (pb, y) in zip(as_leaves(a), as_leaves(b)):
      y = y.to(x.device)
      if pa != pb or x.shape != y.shape or x.dtype != y.dtype:
        fail(f'{what}: leaf {pa} {x.shape} {x.dtype} vs {pb} {y.shape} '
             f'{y.dtype}')
      if not torch.equal(x, y):
        d = (x.double() - y.double()).abs().max().item()
        worst = max(worst, d)
        print(f'  {what}: leaf {pa} differs in '
              f'{int((x != y).sum())} places, max |diff| {d}')
    return worst

  cfg = ct.EnvConfig(reward=False)
  k = cfg.balance_every
  gen = torch.Generator(device=dev)
  gen.manual_seed(0)
  draw = lambda n: torch.randint(0, 17, (k, n), generator=gen, device=dev,
                                 dtype=torch.int32)
  core = ct.CrafterEnv(cfg, dev)

  # 2. Each kernel against its plain twin at main-path shapes.
  vs = ct.vec_reset_chunked(ct.home_keys(1, N_ENVS, dev), cfg)
  for _ in range(WARM_GROUPS):
    vs, _ = ct.vec_step_group(vs, draw(N_ENVS), cfg, RESET_BATCH)
  acts = draw(N_ENVS)
  env = vs.env
  c = cfg.area[0] * cfg.area[1]
  rows = []

  got, ms = timed(lambda: step_cuda.group_tick(env, acts, cfg), 5)
  kernel_ms = device_ms(lambda: step_cuda.group_tick(env, acts, cfg),
                        'group_tick_kernel')
  ref, plain_ms = timed(lambda: step_lib.step_group_plain(env, acts, cfg), 2)
  err = max(max_err(got[0], ref[0], 'group_tick state'),
            max_err(got[1], ref[1], 'group_tick raw'),
            max_err(got[2], ref[2], 'group_tick occ'))
  if err != 0:
    fail('group_tick disagrees with step_group_plain')
  # Active entities of this group, tick by tick: counted on the state that
  # enters each tick (the player moves at most one cell before its mobs).
  xy = torch.arange(c, device=dev)
  cx, cy = xy // cfg.area[1], xy % cfg.area[1]

  def active_entities(st):
    pos = st.player.pos.long()
    pdist = (pos[:, :1] - cx).abs() + (pos[:, 1:] - cy).abs()
    return int(((st.ent.etype > ct.rules.E_PLAYER)
                & (pdist < cfg.update_distance)).sum())

  active, st = 0, env
  for t in range(k):
    active += active_entities(st)
    st = step_cuda.group_tick(st, acts[t:t + 1], cfg)[0]
  print(f'group_tick: {active} active entity-ticks in the group, '
        f'{active / (N_ENVS * c * k):.4%} of cell-ticks', flush=True)
  group_bytes = N_ENVS * c * (6 + 7) + 2 * N_ENVS * step_cuda.REC * 4 \
      + k * N_ENVS * (4 + 6)
  group_ops = active * OPS_TICK_ACTIVE + N_ENVS * k * OPS_TICK_PLAYER
  del st
  rows.append(dict(
      name='group_tick', source='crafter_tpu_torch/csrc/group_tick.cu',
      replaces='crafter_tpu/step.py:1373', max_abs_err=err, ms=ms,
      plain_ms=plain_ms, bytes=group_bytes, ops=group_ops, library_ms=None,
      device_ms=kernel_ms))

  # The same group with render snapshots.
  got_s, ms = timed(lambda: step_cuda.group_tick(env, acts, cfg,
                                                 snapshots=True), 5)
  kernel_ms_s = device_ms(lambda: step_cuda.group_tick(
      env, acts, cfg, snapshots=True), 'group_tick_kernel')
  ref_s, plain_ms = timed(lambda: step_lib.step_group_plain(
      env, acts, cfg, snapshots=True), 2)
  cut = lambda sn: dataclasses.replace(sn, packed=sn.packed[:k - 1])
  err = max(max_err(got_s[0], ref_s[0], 'group_tick_snaps state'),
            max_err(got_s[1], ref_s[1], 'group_tick_snaps raw'),
            max_err(got_s[2], ref_s[2], 'group_tick_snaps occ'),
            max_err(cut(got_s[3]), cut(ref_s[3]), 'group_tick_snaps snaps'),
            max_err(got_s[0], got[0], 'group_tick with vs without snaps'))
  if err != 0:
    fail('group_tick with snapshots disagrees with step_group_plain')
  snap_bytes = (k - 1) * N_ENVS * (c + 4 * 4 + ct.rules.N_ITEMS * 4)
  rows.append(dict(
      name='group_tick_snaps', source='crafter_tpu_torch/csrc/group_tick.cu',
      replaces='crafter_tpu/step.py:1373', max_abs_err=err, ms=ms,
      plain_ms=plain_ms, bytes=group_bytes + snap_bytes, ops=group_ops,
      library_ms=None, device_ms=kernel_ms_s))
  del got_s, ref_s

  # One tick.
  sp, sm, _ = step_lib.tick_seeds(env.key, env.step + 1)
  tk, ms = timed(lambda: step_cuda.tick(env, acts[0], sp, sm, cfg), 5)
  kernel_ms_t = device_ms(lambda: step_cuda.tick(env, acts[0], sp, sm, cfg),
                          'tick_kernel')
  print(f'group and tick kernels on the device alone (profiler): group '
        f'{dev_str(kernel_ms)}, with snapshots {dev_str(kernel_ms_s)}, tick '
        f'{dev_str(kernel_ms_t)} (with the wrapper: {rows[0]["ms"]:.3f}, '
        f'{rows[1]["ms"]:.3f}, {ms:.3f} ms)', flush=True)
  tref, plain_ms = timed(lambda: step_lib.tick_plain(env, acts[0], sp, sm,
                                                     cfg), 2)
  err = max_err(tk, tref, 'tick')
  if err != 0:
    fail('tick disagrees with tick_plain')
  if torch.equal(tk.ent.etype, env.ent.etype):
    fail('the tick moved no entity: the check has no teeth')
  rows.append(dict(
      name='tick', source='crafter_tpu_torch/csrc/group_tick.cu',
      replaces='crafter_tpu/step.py:1235', max_abs_err=err, ms=ms,
      plain_ms=plain_ms,
      bytes=N_ENVS * c * (6 + 6) + 2 * N_ENVS * step_cuda.REC * 4
      + 3 * N_ENVS * 4,
      ops=active_entities(env) * OPS_TICK_ACTIVE + N_ENVS * OPS_TICK_PLAYER,
      library_ms=None, device_ms=kernel_ms_t))
  del tk, tref

  # Both tick kernels on states packed with entities (tests/dense_states.py:
  # players at corners and edges, skeletons that shoot, arrows that hit,
  # zombies that strike), at 4096 envs and on another area (the generic
  # instantiation), and on the hand-built scenes of the CPU tests.
  scenes, scene_acts = dense_states.scene_states()
  cases = [((64, 64), dense_states.dense_states(N_ENVS, 21), None),
           (DENSE_AREA, dense_states.dense_states(
               DENSE_AREA_ENVS, 22, DENSE_AREA), None),
           ((64, 64), scenes, scene_acts)]
  for area, tree, case_acts in cases:
    dcfg = dataclasses.replace(cfg, area=area)
    dense = convert.state_from_numpy(tree, dev)
    nd = dense.step.shape[0]
    if case_acts is None:
      dacts = torch.randint(0, 17, (k, nd), generator=gen, device=dev,
                            dtype=torch.int32)
    else:
      dacts = torch.as_tensor(case_acts[[t % 2 for t in range(k)]],
                              device=dev)
    what = f'{nd} {"scenes" if case_acts is not None else "dense states"}' \
        f' at {area[0]}x{area[1]}'
    for snaps in (False, True):
      dg = step_cuda.group_tick(dense, dacts, dcfg, snapshots=snaps)
      dr = step_lib.step_group_plain(dense, dacts, dcfg, snapshots=snaps)
      if snaps:
        dg, dr = dg[:3] + (cut(dg[3]),), dr[:3] + (cut(dr[3]),)
      if any(max_err(a, b, f'group_tick {what}') for a, b in zip(dg, dr)):
        fail(f'group_tick (snapshots {snaps}) disagrees with '
             f'step_group_plain on {what}')
    sp, sm, _ = step_lib.tick_seeds(dense.key, dense.step + 1)
    tk = step_cuda.tick(dense, dacts[0], sp, sm, dcfg)
    tref = step_lib.tick_plain(dense, dacts[0], sp, sm, dcfg)
    if max_err(tk, tref, f'tick {what}'):
      fail(f'tick disagrees with tick_plain on {what}')
    shots, strikes, hits = dense_states.tick_events(
        tree, convert.to_numpy(tref), area, dcfg.update_distance)
    print(f'{what}: group tick (K = {k}, with and without snapshots) and '
          f'tick bitwise equal to their twins; in the tick '
          f'{int(shots.sum())} skeletons shot, {int(hits.sum())} arrows hit, '
          f'{int(strikes.sum())} zombies struck', flush=True)
    if case_acts is None and not (shots.sum() and hits.sum()
                                  and strikes.sum()):
      fail(f'{what}: no skeleton shot, no arrow hit or no zombie struck: '
           'the check has no teeth')
    del dense, dg, dr, tk, tref

  occ = got[2]
  s_bal = step_lib.tick_seeds(got[0].key, got[0].step)[2]
  bal, ms = timed(lambda: step_cuda.balance(got[0], s_bal, occ, cfg), 5)
  bal_dev_ms = device_ms(lambda: step_cuda.balance(got[0], s_bal, occ, cfg),
                         'balance_kernel')
  bref, plain_ms = timed(
      lambda: step_lib.balance_plain(got[0], s_bal, occ, cfg), 2)
  err = max(max_err(bal, bref, 'balance'),
            max_err(step_cuda.balance(got[0], s_bal, None, cfg),
                    step_lib.balance_plain(got[0], s_bal, None, cfg),
                    'balance without occupancy'))
  if err != 0:
    fail('balance disagrees with balance_plain')
  changed = int((bal.ent.etype != got[0].ent.etype).sum())
  print(f'balance: {changed} cells changed by the pass; {ms:.4f} ms with the '
        f'wrapper, device {dev_str(bal_dev_ms)}, host share '
        f'{host_share(ms, bal_dev_ms)}', flush=True)
  if changed == 0:
    fail('the balance pass changed nothing: the check has no teeth')
  # Dense states past step 10000 at a day length of 200, a third of the
  # worlds all grass (spawn picks on every rank), other chunk sizes and an
  # area whose height is no multiple of 16.
  for area, chunk, nb in BALANCE_CASES:
    bcfg = dataclasses.replace(cfg, area=area, chunk_size=chunk,
                               day_length=200)
    bst = convert.state_from_numpy(
        dense_states.balance_states(nb, 23, area, chunk), dev)
    bseeds = step_lib.tick_seeds(bst.key, bst.step)[2]
    bocc = (torch.rand(bst.ent.etype.shape, generator=gen, device=dev)
            < 0.05).to(torch.uint8)
    what = (f'{nb} dense states at {area[0]}x{area[1]}, '
            f'{chunk[0]}x{chunk[1]} chunks')
    for o in (bocc, None):
      bk = step_cuda.balance(bst, bseeds, o, bcfg)
      if max_err(bk, step_lib.balance_plain(bst, bseeds, o, bcfg),
                 f'balance {what}'):
        fail(f'balance disagrees with balance_plain on {what}')
    moved = int((bk.ent.etype != bst.ent.etype).sum())
    _, bms = timed(lambda: step_cuda.balance(bst, bseeds, bocc, bcfg), 5)
    bdev = device_ms(lambda: step_cuda.balance(bst, bseeds, bocc, bcfg),
                     'balance_kernel')
    print(f'balance on {what}: bitwise equal to the twin with and without '
          f'occupancy, {moved} cells changed; {bms:.4f} ms with the wrapper, '
          f'device {dev_str(bdev)}, host share {host_share(bms, bdev)}',
          flush=True)
    if moved == 0:
      fail(f'the balance changed nothing on {what}: the check has no teeth')
    del bst, bk, bocc
  nch = cfg.n_chunks[0] * cfg.n_chunks[1]
  rows.append(dict(
      name='balance', source='crafter_tpu_torch/csrc/balance.cu',
      replaces='crafter_tpu/step.py:1114', max_abs_err=err, ms=ms,
      plain_ms=plain_ms, bytes=N_ENVS * c * (6 + 4) + N_ENVS * (2 * nch + 16),
      ops=N_ENVS * c * OPS_BALANCE_CELL, library_ms=None,
      device_ms=bal_dev_ms))

  # The 2-D noise in both forms: the shared form (the channels' points
  # once, a seed a world and channel), which worldgen calls, at the shapes
  # of the paths (a reset pass of 320 worlds, a chunk of vec_reset_chunked,
  # the per-tick reset pass of 32), and the per-point form at 320 worlds.
  shared_pts = worldgen.channel_points(cfg, dev).reshape(
      len(worldgen.CHANNELS), c, 2)
  for worlds in NOISE_WORLDS:
    keys = ct.prng.fold_in(ct.home_keys(2, worlds, dev), 2)
    row_seeds = worldgen.noise_seeds(keys)
    nz, ms = timed(lambda: noise_cuda.noise2(shared_pts, row_seeds), 10)
    dev_ms = device_ms(lambda: noise_cuda.noise2(shared_pts, row_seeds),
                       'noise2_shared_kernel')
    nref, plain_ms = timed(lambda: noise.noise2_shared(shared_pts,
                                                       row_seeds), 2)
    err = (nz - nref).abs().max().item()
    ndiff = int((nz != nref).sum())
    pts, seeds = worldgen.noise_inputs(keys, cfg)
    flat, flat_ms = timed(lambda: noise_cuda.noise2(pts, seeds), 10)
    flat_dev_ms = device_ms(lambda: noise_cuda.noise2(pts, seeds),
                            'noise2_kernel')
    flat_err = (flat - nz.reshape(-1)).abs().max().item()
    wk = worldgen.generate_world(keys, cfg)
    wp = worldgen.generate_world(keys, dataclasses.replace(cfg,
                                                           noise_mode='fast'))
    flips = int((wk.mat_map != wp.mat_map).sum())
    print(f'noise2 at {worlds} worlds: shared form {ms:.3f} ms (device '
          f'{dev_str(dev_ms)}), per-point form {flat_ms:.3f} ms (device '
          f'{dev_str(flat_dev_ms)}); {ndiff} of {nz.numel()} values differ '
          f'from the twin, max |diff| {err}, the forms differ by {flat_err}; '
          f'{flips} materials flipped', flush=True)
    if (err > NOISE_ATOL or flat_err > NOISE_ATOL or flips != 0
        or max_err(wk, wp, 'worldgen') != 0):
      fail(f'noise2 disagrees with its twin at {worlds} worlds')
    # The same worlds made on the CPU, where the tests hold them against the
    # reference: every leaf must be equal (the float32 math of the material
    # cascade gives the same bits on both devices).
    if worlds != 512:
      wc = worldgen.generate_world(keys.cpu(), cfg)
      if max_err(wk, wc, 'worldgen card vs CPU') != 0:
        fail(f'{worlds} worlds made on the card differ from the CPU\'s')
      print(f'worldgen: {worlds} worlds on the card == on the CPU',
            flush=True)
      del wc
    p = nz.numel()
    rows.append(dict(
        name='noise2' if worlds == RESET_BATCH else f'noise2_{worlds}',
        source='crafter_tpu_torch/csrc/noise2.cu',
        replaces='crafter_tpu/ops/noise_pallas.py:99', max_abs_err=err,
        ms=ms, plain_ms=plain_ms,
        bytes=p * 4 + shared_pts.numel() * 4 + row_seeds.numel() * 4,
        ops=p * OPS_NOISE_POINT, library_ms=None, device_ms=dev_ms,
        worlds=worlds))
    del nz, nref, wk, wp, pts, seeds, flat
  keys = ct.prng.fold_in(ct.home_keys(2, RESET_BATCH, dev), 2)
  del got, ref, bal, bref

  # The render kernel on one pixel group's frames (K * N): the stepped
  # worlds under players spread over the whole map (a share of them within
  # the view's reach of an edge), steps over the whole day, one frame in
  # five asleep, inventories of 0..12.
  b = k * N_ENVS
  rnd = lambda hi, shape: torch.randint(0, hi, shape, generator=gen,
                                        device=dev, dtype=torch.int32)
  atlas = core.atlas
  packed = step_lib.pack_cells(env.mat_map, env.ent.etype, env.ent.aux,
                               env.ent.facing).repeat(k, 1)
  ppos = rnd(cfg.area[0], (b, 2))
  steps = torch.arange(b, device=dev, dtype=torch.int32) % cfg.day_length
  sleeping = rnd(5, (b,)) == 0
  win79 = render_lib.window_prep(packed, ppos, rnd(4, (b,)), sleeping,
                                 rnd(13, (b, ct.rules.N_ITEMS)), cfg)
  light, day_ms = timed(lambda: ct.daylight(steps, cfg.day_length), 5)
  plain_light, day_plain_ms = timed(
      lambda: ct.state.daylight_plain(steps, cfg.day_length), 3)
  print(f'daylight kernel on {b} steps: {day_ms:.4f} ms with the wrapper '
        f'(plain {day_plain_ms:.4f} ms), equal to the plain form: '
        f'{torch.equal(light, plain_light)}', flush=True)
  if not torch.equal(light, plain_light):
    fail('the daylight kernel disagrees with daylight_plain')

  # The threefry kernel (no TPU kernel behind it either: XLA fuses
  # jax.random) against its int64 twin, prng.threefry2x32 run on the card,
  # on the draws of a reset pass: fold_in by int32 data (some negative) and
  # by a Python int, split(keys, 3), randint's split and its two bit draws,
  # and the material and object uniform planes.  Each draw must be one
  # launch and equal the twin bit for bit.
  def twin(tkeys, ctr):
    return ct.prng.threefry2x32(tkeys[..., None, 0], tkeys[..., None, 1],
                                torch.zeros_like(ctr), ctr)

  pairs = lambda b: torch.stack(b, -1)
  xor = lambda b: b[0] ^ b[1]
  unit = lambda b: (((b[0] ^ b[1]) >> 9) | 0x3F800000).to(
      torch.int32).view(torch.float32) - 1.0
  ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
  w, h = cfg.area
  for worlds in THREEFRY_WORLDS:
    tkeys = ct.prng.fold_in(ct.home_keys(3, worlds, dev), 3)
    data = torch.arange(worlds, dtype=torch.int32, device=dev) * 40503 \
        - 2 ** 30
    sub = ct.prng.split(tkeys, 3)
    halves = ct.prng.split(sub[:, 0], 2)
    draws = (
        ('fold_in, int32 data', lambda: ct.prng.fold_in(tkeys, data),
         lambda: pairs(twin(tkeys, (data.to(torch.int64) & 0xFFFFFFFF)[
             :, None]))[:, 0]),
        ('fold_in, 0x5eed', lambda: ct.prng.fold_in(tkeys, 0x5eed),
         lambda: pairs(twin(tkeys, ar(1) + 0x5eed))[:, 0]),
        ('split 3', lambda: ct.prng.split(tkeys, 3),
         lambda: pairs(twin(tkeys, ar(3)))),
        ('split 2', lambda: ct.prng.split(sub[:, 0], 2),
         lambda: pairs(twin(sub[:, 0], ar(2)))),
        ('bits (), hi', lambda: ct.prng.random_bits(halves[:, 0], ()),
         lambda: xor(twin(halves[:, 0], ar(1)))[:, 0]),
        ('bits (), lo', lambda: ct.prng.random_bits(halves[:, 1], ()),
         lambda: xor(twin(halves[:, 1], ar(1)))[:, 0]),
        (f'uniform (4, {w}, {h})',
         lambda: ct.prng.uniform(sub[:, 1], (4, w, h)),
         lambda: unit(twin(sub[:, 1], ar(4 * w * h))).reshape(
             worlds, 4, w, h)),
        (f'uniform (3, {w}, {h})',
         lambda: ct.prng.uniform(sub[:, 2], (3, w, h)),
         lambda: unit(twin(sub[:, 2], ar(3 * w * h))).reshape(
             worlds, 3, w, h)))
    for what, kernel, plain in draws:
      before = prng_cuda.draw.launches
      got_draw = kernel()
      if prng_cuda.draw.launches != before + 1:
        fail(f'threefry {what} at {worlds} keys: '
             f'{prng_cuda.draw.launches - before} launches, not 1')
      want_draw = plain()
      if got_draw.dtype != want_draw.dtype \
          or not torch.equal(got_draw, want_draw):
        bad = (got_draw != want_draw).sum() if (
            got_draw.shape == want_draw.shape) else 'shape'
        fail(f'threefry {what} at {worlds} keys differs from the twin: '
             f'{got_draw.dtype} {tuple(got_draw.shape)} against '
             f'{want_draw.dtype} {tuple(want_draw.shape)}, {bad} differ')
      del got_draw, want_draw
    print(f'threefry kernel at {worlds} keys: {len(draws)} draws of a '
          'reset pass, one launch each, == the int64 twin on the card',
          flush=True)
  del tkeys, data, sub, halves
  torch.cuda.empty_cache()
  seeds = render_lib.noise_seed(env.key.repeat(k, 1), steps)
  n_night, n_sleep = int((light < 0.5).sum()), int(sleeping.sum())
  n_edge = int((win79[:, :63] & 15 == render_lib.GRAY_ID).any(1).sum())
  print(f'render_win79: {b} frames, {n_night} at night, {n_sleep} asleep, '
        f'{n_edge} showing the map\'s edge', flush=True)
  if not (n_night and n_sleep and n_edge):
    fail('the render check needs night, sleeping and edge frames')
  del packed
  render = lambda n, fmt, inst='auto': render_cuda.render_win79(
      win79[:n], light[:n], sleeping[:n], seeds[:n], atlas, cfg.size, fmt,
      instantiation=inst)
  frames, ms = timed(lambda: render(b, 'frames'), 5)
  dev_ms = device_ms(lambda: render(b, 'frames'), 'render_kernel')
  # The per-tick path and the training rollout render one frame an env.
  frames_tick, ms_tick = timed(lambda: render(N_ENVS, 'frames'), 5)
  dev_ms_tick = device_ms(lambda: render(N_ENVS, 'frames'), 'render_kernel')
  lanes, packed_ms = timed(lambda: render(b, 'packed'), 5)
  # The instantiation that reads the tables from global memory, on the
  # same frames.
  frames_g, ms_g = timed(lambda: render(b, 'frames', 'global'), 5)
  dev_ms_g = device_ms(lambda: render(b, 'frames', 'global'),
                       'render_kernel')
  # The twin in chunks (its intermediates are (B, P) planes), timed alone.
  bad_px = torch.zeros((), dtype=torch.int64, device=dev)
  worst = torch.zeros((), dtype=torch.int16, device=dev)   # in colour levels
  spans = []
  for i in range(0, b, TWIN_CHUNK):
    j = slice(i, i + TWIN_CHUNK)
    spans.append([torch.cuda.Event(enable_timing=True) for _ in range(2)])
    spans[-1][0].record()
    want = render_lib.render_win79_plain(win79[j], light[j], sleeping[j],
                                         seeds[j], atlas)
    spans[-1][1].record()
    image = render_lib.frame_image(want, cfg.size)
    bad_px += ((lanes[j] != want).sum() + (frames[j] != image).sum()
               + (frames_g[j] != image).sum())
    for got_px in (frames[j], frames_g[j],
                   render_lib.frame_image(lanes[j], cfg.size)):
      worst = torch.maximum(worst, (got_px.to(torch.int16)
                                    - image.to(torch.int16)).abs().max())
    if i == 0:
      bad_px += (frames_tick != image).sum()
  torch.cuda.synchronize()
  plain_ms = sum(t0.elapsed_time(t1) for t0, t1 in spans)
  err = float(worst)
  print(f'render_win79: packed output {packed_ms:.3f} ms, frames output '
        f'{ms:.3f} ms (device {dev_str(dev_ms)}; {N_ENVS} frames: '
        f'{ms_tick:.3f} ms, device {dev_str(dev_ms_tick)}); the global '
        f'instantiation {ms_g:.3f} ms (device {dev_str(dev_ms_g)}); '
        f'{int(bad_px)} values differ from the twin, max |diff| {err}',
        flush=True)
  if int(bad_px) != 0 or err != 0:
    fail('render_win79 disagrees with render_win79_plain')
  del frames_g, frames_tick
  # A size whose tables do not fit in shared memory: the global
  # instantiation, which 'auto' picks there.
  big = ct.bake_atlas(RENDER_BIG, cfg.view, cfg.item_rows, dev)
  nb = RENDER_BIG_FRAMES
  args = (win79[:nb], light[:nb], sleeping[:nb], seeds[:nb], big)
  big_frames, ms_big = timed(lambda: render_cuda.render_win79(
      *args, RENDER_BIG, 'frames'), 3)
  dev_ms_big = device_ms(lambda: render_cuda.render_win79(
      *args, RENDER_BIG, 'frames'), 'render_kernel')
  want_big = render_lib.frame_image(render_lib.render_win79_plain(*args),
                                    RENDER_BIG)
  bad_big = int((big_frames != want_big).sum())
  print(f'render_win79 at {RENDER_BIG[0]}x{RENDER_BIG[1]}, {nb} frames '
        f'(global tables): {ms_big:.3f} ms (device {dev_str(dev_ms_big)}), '
        f'{bad_big} bytes differ from the twin', flush=True)
  if bad_big:
    fail(f'render_win79 at {RENDER_BIG} disagrees with render_win79_plain')
  del big, big_frames, want_big, args
  pix = atlas.src.shape[0]
  lit_pix = int(atlas.view_mask.sum())
  table_bytes = sum(t.numel() * t.element_size()
                    for _, t in leaves(atlas.compact)
                    if isinstance(t, torch.Tensor))
  render_bytes = lambda frames: (frames * (win79.shape[1] * 4 + 12)
                                 + table_bytes + frames * pix * 3)
  render_ops = lambda frames, night: (
      frames * (pix * OPS_RENDER_TEXEL + lit_pix * OPS_RENDER_LIGHT)
      + night * lit_pix * OPS_RENDER_NOISE)
  night_tick = int((light[:N_ENVS] < 0.5).sum())
  print(f'render_win79 at {N_ENVS} frames ({night_tick} at night): '
        f'{ms_tick:.3f} ms', flush=True)
  rows.append(dict(
      name='render_win79', source='crafter_tpu_torch/csrc/render.cu',
      replaces='crafter_tpu/render.py:567', max_abs_err=err, ms=ms,
      plain_ms=plain_ms, bytes=render_bytes(b), ops=render_ops(b, n_night),
      library_ms=None, device_ms=dev_ms))
  rows.append(dict(
      name='render_win79_4096', source='crafter_tpu_torch/csrc/render.cu',
      replaces='crafter_tpu/render.py:567', max_abs_err=err, ms=ms_tick,
      plain_ms=sum(t0.elapsed_time(t1) for t0, t1 in spans[:1]),
      bytes=render_bytes(N_ENVS), ops=render_ops(N_ENVS, night_tick),
      library_ms=None, device_ms=dev_ms_tick))
  del frames, lanes, win79, want, image, got_px, env, vs
  torch.cuda.empty_cache()

  # The 3-D noise on the 3-D form of that reset pass's points: each
  # channel's z (crafter_tpu/worldgen.py:44-58) as the third coordinate and
  # the world's own seed at every point.
  pts2, _ = worldgen.noise_inputs(keys, cfg)
  zs = torch.tensor([ch[4] for ch in worldgen.CHANNELS], dtype=torch.float32,
                    device=dev)
  pts3 = torch.cat([pts2.reshape(RESET_BATCH, len(zs), c, 2),
                    zs[None, :, None, None].expand(RESET_BATCH, -1, c, 1)],
                   -1)
  world_seed = ct.prng.randint(ct.prng.split(keys, 3)[:, 0], 0, 2 ** 31 - 1)
  seeds3 = world_seed[:, None, None].expand(pts3.shape[:-1]).contiguous()
  nz, ms = timed(lambda: noise_cuda.noise3(pts3, seeds3), 10)
  n3_dev_ms = device_ms(lambda: noise_cuda.noise3(pts3, seeds3),
                        'noise3_kernel')
  nref, plain_ms = timed(lambda: noise.noise3_fast(pts3, seeds3), 2)
  err = (nz - nref).abs().max().item()
  ndiff = int((nz != nref).sum())
  one_seed = int(world_seed[0])
  same = torch.equal(noise_cuda.noise3(pts3[0], one_seed),
                     noise.noise3_fast(pts3[0], one_seed))
  print(f'noise3: {ndiff} of {nz.numel()} values differ, max |diff| {err}, '
        f'field in [{float(nz.min()):.3f}, {float(nz.max()):.3f}]; one seed '
        f'for all points {"equal" if same else "differs"}', flush=True)
  if err > NOISE_ATOL or not same or float(nz.abs().max()) < 0.5:
    fail('noise3 disagrees with noise3_fast')
  p3 = nz.numel()
  rows.append(dict(
      name='noise3', source='crafter_tpu_torch/csrc/noise3.cu',
      replaces='crafter_tpu/ops/noise_pallas.py:134', max_abs_err=err, ms=ms,
      plain_ms=plain_ms, bytes=p3 * (12 + 4 + 4), ops=p3 * OPS_NOISE3_POINT,
      library_ms=None, device_ms=n3_dev_ms))
  del pts2, pts3, seeds3, nz, nref, keys

  # The roll micro-bench kernel on its rows, all three kinds at 10 and 40
  # stages; the twin in row chunks.  The table's row is 'roll' at 10 stages.
  # No one PyTorch call computes ten masked stages, so the row has no
  # library time; one torch.roll of the rows (one stage's rotate) is timed
  # to price a rotate.
  for roll_kind in roll_cuda.KINDS:
    blocks, smem, depth = roll_cuda.occupancy(roll_kind)
    print(f'occupancy: roll kernel, {roll_kind}: {blocks} blocks of 256 '
          f'threads per SM, {smem} bytes of shared memory a block, a ring of '
          f'{depth} rows', flush=True)
    if blocks == 0:
      fail(f'the roll kernel cannot run for {roll_kind}')
  x = torch.randint(0, 1 << 24, (ROLL_ROWS, roll_cuda.COLS), generator=gen,
                    device=dev, dtype=torch.int32)
  roll_ms = {}
  for roll_kind in roll_cuda.KINDS:
    for stages in (10, 40):
      got_x, ms = timed(lambda: roll_cuda.roll_stages(x, roll_kind, stages), 3)
      bad, spans = 0, []
      for i in range(0, ROLL_ROWS, TWIN_CHUNK):
        spans.append([torch.cuda.Event(enable_timing=True) for _ in range(2)])
        spans[-1][0].record()
        want_x = roll_cuda.roll_stages_plain(x[i:i + TWIN_CHUNK], roll_kind,
                                           stages)
        spans[-1][1].record()
        bad += int((got_x[i:i + TWIN_CHUNK] != want_x).sum())
      torch.cuda.synchronize()
      plain_ms = sum(t0.elapsed_time(t1) for t0, t1 in spans)
      roll_ms[roll_kind, stages] = (ms, plain_ms)
      print(f'roll: {roll_kind:5} x{stages:2}: {ms:.3f} ms '
            f'({ms * 1e3 / stages:.2f} us/stage), plain {plain_ms:.3f} ms, '
            f'{bad} values differ', flush=True)
      if bad or torch.equal(got_x, x):
        fail(f'roll_stages({roll_kind}, {stages}) disagrees with its plain '
             'twin')
  _, lib_ms = timed(lambda: torch.roll(x, -1, dims=1), 3)
  roll_dev_ms = device_ms(lambda: roll_cuda.roll_stages(x, 'roll', 10),
                          'roll_kernel', 3)
  # Its share of the bound over repeats: events with the wrapper, and the
  # profiler's device time.
  roll_bound = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
  ev = [timed(lambda: roll_cuda.roll_stages(x, 'roll', 10), 3)[1]
        for _ in range(ROLL_REPEATS)]
  pr = [device_ms(lambda: roll_cuda.roll_stages(x, 'roll', 10),
                  'roll_kernel', 3) for _ in range(ROLL_REPEATS)]
  shares = lambda ts: ', '.join('not measured' if t is None
                                else f'{roll_bound / t:.1%}' for t in ts)
  print(f'roll x10 over {ROLL_REPEATS} repeats, bound {roll_bound:.4f} ms: '
        f'events {", ".join(f"{t:.4f}" for t in ev)} ms (bound share '
        f'{shares(ev)}); profiler {", ".join(dev_str(t) for t in pr)} '
        f'(bound share {shares(pr)})', flush=True)
  stage_us = lambda name: (roll_ms[name, 40][0] - roll_ms[name, 10][0]) \
      / 30 * 1e3
  print(f'roll: one torch.roll of the rows {lib_ms:.3f} ms; a roll stage '
        f'costs {stage_us("roll"):.2f} us, a control stage '
        f'{stage_us("ctl"):.2f} us (from 10 to 40 stages)', flush=True)
  rows.append(dict(
      name='roll', source='crafter_tpu_torch/csrc/roll.cu',
      replaces='tools/bench_roll.py:23', max_abs_err=0.0,
      ms=roll_ms['roll', 10][0], plain_ms=roll_ms['roll', 10][1],
      bytes=2 * x.numel() * 4, ops=10 * x.numel(), library_ms=None,
      device_ms=roll_dev_ms))
  del x, got_x, want_x
  torch.cuda.empty_cache()

  # 3. The paths, counted and timed.
  # The daylight kernel replaces no TPU kernel (XLA fuses the JAX
  # function): it is counted but has no row in the kernel table.
  wrappers = {'group_tick': step_cuda.group_tick, 'tick': step_cuda.tick,
              'balance': step_cuda.balance, 'noise2': noise_cuda.noise2,
              'render_win79': render_cuda.render_win79,
              'noise3': noise_cuda.noise3, 'roll': roll_cuda.roll_stages,
              'daylight': ct.daylight, 'threefry': prng_cuda.draw,
              'noise3_perm': noise_cuda.noise3_perm}

  def zero_counts():
    for fn in wrappers.values():
      fn.launches = 0
    noise_cuda.noise2.launches_by_rows = {}

  def read_counts(path, needed):
    counts = {name: fn.launches for name, fn in wrappers.items()}
    # The noise kernel's launches by shape, as its wrapper counts them.
    for worlds in NOISE_WORLDS:
      counts[f'noise2_rows_{worlds}'] = \
          noise_cuda.noise2.launches_by_rows.get(worlds, 0)
    for name in needed:
      if counts[name] == 0:
        fail(f'kernel {name} was not launched on the {path} path')
    return counts

  def check_advanced(vs, vs0, ticks, path):
    stepped = (vs.env.step - vs0.env.step) == ticks
    reset = vs.episode > vs0.episode
    bad = int((~(stepped | reset)).sum())
    if bad:
      fail(f'{path} path: {bad} envs neither stepped nor reset')

  def profile(fn, reps, unit, path):
    """Device busy share and top device operations over ``reps`` calls."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      for _ in range(reps):
        fn()
      torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side entries only (kernels, copies): the host operators that
    # launched them report the same device time again.
    dev_us = lambda e: getattr(e, 'self_device_time_total', 0)
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    n_launch = sum(e.count for e in events if dev_us(e) > 0)
    print(f'profile of {reps} {unit}s of the {path} path on {card}: wall '
          f'{wall_ms / reps:.1f} ms/{unit}, device busy '
          f'{busy_ms / reps:.1f} ms/{unit} '
          f'({100 * busy_ms / wall_ms:.1f}%), {n_launch / reps:.0f} device '
          f'operations/{unit}; top device time:', flush=True)
    for e in events[:TOP_OPS]:
      if dev_us(e) > 0:
        print(f'  {dev_us(e) / 1e3 / reps:8.3f} ms/{unit} '
              f'{e.count / reps:7.1f}/{unit}  {e.key[:70]}')
    return wall_ms / reps, busy_ms / reps, n_launch / reps

  # 3a, 3b. The state-only path and the pixel path (one frame per tick and
  # env), in turns (state, pixel, state, pixel) so that the two are compared
  # within one run of the host.
  zero_counts()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  vs = ct.vec_reset_chunked(ct.home_keys(0, N_ENVS, dev), cfg)
  torch.cuda.synchronize()
  reset_s = time.perf_counter() - t0
  reset_counts = read_counts('reset', ('noise2', 'threefry'))

  def run_state(vs, groups):
    """Warm-up group, then ``groups`` timed groups: (vs, ms, episodes)."""
    vs, _ = ct.vec_step_group(vs, draw(N_ENVS), cfg, RESET_BATCH)
    vs0 = vs
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    dones = 0
    for _ in range(groups):
      vs, outs = ct.vec_step_group(vs, draw(N_ENVS), cfg, RESET_BATCH)
      dones = dones + outs.ended.sum()
    end.record()
    torch.cuda.synchronize()
    check_advanced(vs, vs0, groups * k, 'state-only')
    return vs, start.elapsed_time(end), int(dones)

  def run_pixel(vs, groups):
    """The same with frames, a pixel of every frame read: (vs, ms, sum of
    those pixels, the last tick's frames)."""
    vs, _, obs = ct.vec_step_group_obs(vs, draw(N_ENVS), cfg, RESET_BATCH,
                                       core)
    vs0 = vs
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    seen = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(groups):
      vs, outs, obs = ct.vec_step_group_obs(vs, draw(N_ENVS), cfg,
                                            RESET_BATCH, core)
      seen += obs[:, :, 31, 31].sum()
    end.record()
    torch.cuda.synchronize()
    check_advanced(vs, vs0, groups * k, 'pixel')
    if obs.shape != (k, N_ENVS, cfg.size[1], cfg.size[0], 3) \
        or obs.dtype != torch.uint8:
      fail(f'pixel path: obs {tuple(obs.shape)} {obs.dtype}')
    if int(seen) == 0 or int((obs[0] != obs[k - 1]).sum()) == 0:
      fail('pixel path: the frames are empty or do not change over a group')
    return vs, start.elapsed_time(end), int(seen), obs[k - 1]

  add = lambda x, y: {name: x[name] + y[name] for name in x}
  state_counts, pixel_counts = reset_counts, None
  state_ms, pixel_ms = [], []
  for turn in range(2):
    zero_counts()
    vs, ms, dones = run_state(vs, MAIN_GROUPS)
    state_counts = add(state_counts, read_counts(
        'state-only', ('group_tick', 'balance', 'noise2', 'threefry')))
    state_ms.append(ms)
    print(f'state-only path on {card}, turn {turn + 1}: {MAIN_GROUPS} groups '
          f'x {k} ticks x {N_ENVS} envs in {ms:.1f} ms = '
          f'{N_ENVS * k * MAIN_GROUPS / (ms / 1e3):,.0f} env-steps/s '
          f'({ms / MAIN_GROUPS:.2f} ms/group, {dones} episodes ended)',
          flush=True)
    zero_counts()
    vs, ms, seen, last = run_pixel(vs, PIXEL_GROUPS)
    counts = read_counts('pixel', ('group_tick', 'balance', 'noise2',
                                   'threefry', 'render_win79', 'daylight'))
    if not torch.equal(last, core.observe_batch(vs.env)):
      fail('pixel path: the last frame is not the frame of the final state')
    del last
    pixel_counts = counts if pixel_counts is None else add(pixel_counts,
                                                           counts)
    pixel_ms.append(ms)
    print(f'pixel path on {card}, turn {turn + 1}: {PIXEL_GROUPS} groups x '
          f'{k} ticks x {N_ENVS} envs in {ms:.1f} ms = '
          f'{N_ENVS * k * PIXEL_GROUPS / (ms / 1e3):,.0f} env-steps/s '
          f'({ms / PIXEL_GROUPS:.2f} ms/group, pixel checksum {seen})',
          flush=True)
  sps = 2 * N_ENVS * k * MAIN_GROUPS / (sum(state_ms) / 1e3)
  pixel_sps = 2 * N_ENVS * k * PIXEL_GROUPS / (sum(pixel_ms) / 1e3)
  print(f'both turns on {card}: reset of {N_ENVS} envs {reset_s:.2f} s; '
        f'state-only {sps:,.0f} env-steps/s (launches {state_counts}); '
        f'pixel {pixel_sps:,.0f} env-steps/s (launches {pixel_counts})',
        flush=True)

  # Where a group's time goes: the reset pass alone (CUDA events), and the
  # device's busy share and top operations of each path.
  done = torch.rand(N_ENVS, generator=gen, device=dev) < 0.1
  _, reset_ms = timed(lambda: env_lib._reset_pass(
      vs.env, done, vs.episode, vs.home_key, cfg, RESET_BATCH), 3)
  print(f'reset pass of {RESET_BATCH} worlds on {card}: {reset_ms:.2f} ms',
        flush=True)
  box = [vs]

  def state_group():
    box[0], _ = ct.vec_step_group(box[0], draw(N_ENVS), cfg, RESET_BATCH)

  def pixel_group():
    box[0], _, frames = ct.vec_step_group_obs(box[0], draw(N_ENVS), cfg,
                                              RESET_BATCH, core)

  profile(state_group, PROFILE_GROUPS, 'group', 'state-only')
  profile(pixel_group, PROFILE_GROUPS, 'group', 'pixel')
  del box, vs
  torch.cuda.empty_cache()

  # 3c. The per-tick path: VecEnv, one frame batch per step.
  zero_counts()
  venv = ct.VecEnv(N_ENVS, cfg, seed=3, device=dev)
  obs = venv.reset()
  obs, _, _, _ = venv.step(draw(N_ENVS)[0])                       # warm-up
  vs0 = venv.state
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  seen = torch.zeros((), dtype=torch.int64, device=dev)
  for i in range(TICKS):
    obs, reward, done, info = venv.step(draw(N_ENVS)[0])
    seen += obs[:, 31, 31].sum()
  end.record()
  torch.cuda.synchronize()
  tick_ms = start.elapsed_time(end)
  tick_counts = read_counts('per-tick', ('tick', 'balance', 'noise2',
                                        'threefry', 'render_win79',
                                        'daylight'))
  check_advanced(venv.state, vs0, TICKS, 'per-tick')
  if obs.shape != (N_ENVS, cfg.size[1], cfg.size[0], 3) \
      or info['semantic'].shape != (N_ENVS,) + tuple(cfg.area):
    fail(f'per-tick path: obs {tuple(obs.shape)}, semantic '
         f'{tuple(info["semantic"].shape)}')
  if tick_counts['balance'] != (TICKS + 1) // k \
      or tick_counts['tick'] != TICKS + 1:
    fail(f'per-tick path: launches {tick_counts} over {TICKS + 1} ticks')
  if not (torch.isfinite(reward).all() and int(seen) > 0):
    fail('per-tick path: rewards not finite or frames empty')
  tick_sps = N_ENVS * TICKS / (tick_ms / 1e3)
  print(f'per-tick path on {card}: {TICKS} VecEnv.step x {N_ENVS} envs '
        f'(reset_batch {venv.reset_batch}) in {tick_ms:.1f} ms = '
        f'{tick_sps:,.0f} env-steps/s ({tick_ms / TICKS:.2f} ms/tick, '
        f'launches {tick_counts})', flush=True)
  profile(lambda: venv.step(draw(N_ENVS)[0]), 2 * PROFILE_GROUPS, 'tick',
          'per-tick')
  del venv, obs, vs0, info
  torch.cuda.empty_cache()

  # 3d. The training path at full width: PPO on 4096 envs, a rollout of 64
  # ticks (the per-tick cadence: 64 is no multiple of K), 3 epochs of 8
  # minibatches of 32768 frames through the full NatureCNN.
  zero_counts()
  env_cfg = ct.EnvConfig()
  ppo = ct.PPO(env_cfg, ct.PPOConfig(
      num_envs=PPO_ENVS, rollout_len=PPO_ROLLOUT, epochs=PPO_EPOCHS,
      minibatches=PPO_MINIBATCHES, reset_batch=PPO_RESET), device=dev)
  torch.cuda.reset_peak_memory_stats()
  ts = ppo.init(ct.prng.key(0, dev))
  params0 = {name: q.detach().clone()
             for name, q in ts.params.named_parameters()}
  # The split of an update: an event where the rollout hands over to the
  # learner.
  marks = []
  inner_learn = ppo._learn

  def marked_learn(*args):
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    return inner_learn(*args)

  ppo._learn = marked_learn
  ts, metrics, stats = ppo.train_step_with_stats(ts)              # warm-up
  update_ms, rollout_ms = [], []
  for _ in range(2):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    ts, metrics, stats = ppo.train_step_with_stats(ts)
    end.record()
    torch.cuda.synchronize()
    update_ms.append(start.elapsed_time(end))
    rollout_ms.append(start.elapsed_time(marks[-1]))
    ended = int(metrics['episodes_done'])
    if int(stats['count']) + int(stats['dropped']) != ended:
      fail(f'training path: stats count {int(stats["count"])} + dropped '
           f'{int(stats["dropped"])} != {ended} episodes ended')
  ppo_counts = read_counts('training', ('tick', 'balance', 'noise2',
                                       'threefry', 'render_win79',
                                       'daylight'))
  steps_per_update = PPO_ENVS * PPO_ROLLOUT
  if ts.update != 3 or ts.env_steps != 3 * steps_per_update:
    fail(f'training path: update {ts.update}, env_steps {ts.env_steps}')
  values = {name: float(v) for name, v in metrics.items()}
  if not all(math.isfinite(v) for v in values.values()):
    fail(f'training path: metrics {values}')
  if not 0 < values['entropy'] <= math.log(ct.rules.N_ACTIONS) + 1e-6:
    fail(f'training path: entropy {values["entropy"]}')
  for layer in ('conv1', 'conv2', 'conv3', 'dense', 'logits', 'value'):
    if not any(not torch.equal(q.detach(), params0[name])
               for name, q in ts.params.named_parameters()
               if name.startswith(layer + '.')):
      fail(f'training path: no parameter of {layer} changed')
  if ts.obs.shape != (PPO_ENVS, env_cfg.size[1], env_cfg.size[0], 3) \
      or int(ts.vec.tick) != 3 * PPO_ROLLOUT:
    fail(f'training path: obs {tuple(ts.obs.shape)}, tick {int(ts.vec.tick)}')
  ppo_sps = 2 * steps_per_update / (sum(update_ms) / 1e3)
  ppo_ms = sum(update_ms) / 2
  ppo_rollout_ms = sum(rollout_ms) / 2
  print(f'training path on {card}: {PPO_ENVS} envs x {PPO_ROLLOUT} ticks, '
        f'{PPO_EPOCHS} epochs x {PPO_MINIBATCHES} minibatches: updates '
        f'{update_ms[0]:.1f} / {update_ms[1]:.1f} ms = {ppo_sps:,.0f} '
        f'env-steps/s; rollout {ppo_rollout_ms:.1f} ms '
        f'({ppo_rollout_ms / PPO_ROLLOUT:.2f} ms/tick), learn '
        f'{ppo_ms - ppo_rollout_ms:.1f} ms; metrics {values}; peak memory '
        f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches '
        f'{ppo_counts}', flush=True)
  box = [ts]

  def one_update():
    box[0], _ = ppo.train_step(box[0])

  profile(one_update, 1, 'update', 'training')
  ppo._learn = inner_learn
  trained = box[0].params                 # phase 4 compares it with the CPU
  trained_obs = box[0].obs[:256].clone()
  del box, ts, stats, metrics, params0, ppo
  torch.cuda.empty_cache()

  # 3e. The two kernels that no entry point of the package reaches, through
  # what their users call: the noise3 wrapper itself, on one world's 3-D
  # points, and the roll micro-bench tool.
  zero_counts()
  pts2, _ = worldgen.noise_inputs(ct.home_keys(5, 1, dev), cfg)
  field = noise_cuda.noise3(
      torch.cat([pts2, zs[:, None].expand(-1, c).reshape(-1, 1)], -1), 5)
  if not (torch.isfinite(field).all() and float(field.abs().max()) > 0.5):
    fail('noise3: the field is not finite or is flat')
  argv = sys.argv
  sys.argv = [argv[0]]
  try:
    runpy.run_path(str(root / 'tools' / 'bench_roll_cuda.py'),
                   run_name='__main__')
  finally:
    sys.argv = argv
  tool_counts = read_counts('noise3 and roll tool', ('noise3', 'roll'))
  del pts2, field

  # 3f. The port's bench at its defaults (4096 envs, scans of 400 ticks
  # state-only and 200 pixel, three repeats; its every-env check on each):
  # its JSON line, and the kernels it went through.
  torch.cuda.empty_cache()
  zero_counts()
  bench = runpy.run_path(str(root / 'bench_cuda.py'), run_name='bench_cuda')
  bench_rec = bench['main']([])
  bench_counts = read_counts('bench', ('group_tick', 'balance', 'noise2',
                                      'threefry', 'render_win79',
                                      'daylight'))
  if not (bench_rec['value'] > 0 and bench_rec['pixel_value'] > 0):
    fail(f'bench: {bench_rec}')
  print(f'bench_cuda.py on {card}: launches {bench_counts}', flush=True)
  del bench
  torch.cuda.empty_cache()

  # 4. Kernel path on the card == the CPU's plain twins, across episode
  # ends, at 13 envs: state-only groups, pixel groups, VecEnv ticks.
  small = dataclasses.replace(cfg, length=25)
  va = ct.vec_reset(ct.home_keys(9, 13, dev), small)
  vc = ct.vec_reset(ct.home_keys(9, 13, 'cpu'), small)
  for g in range(3):
    a = draw(13)
    va, oa = ct.vec_step_group(va, a, small, 4)
    vc, oc = ct.vec_step_group(vc, a.cpu(), small, 4)
    if (max_err(va, vc, f'small group {g} vs CPU')
        or max_err(oa, oc, 'small outs vs CPU')):
      fail(f'the card and the CPU differ at 13 envs, group {g}')
  print(f'13 envs x 3 groups: kernel path == plain path on the CPU '
        f'({int(va.episode.sum())} episodes begun, '
        f'{int(va.pending.sum())} pending)', flush=True)

  core_cpu = ct.CrafterEnv(small, 'cpu')
  va = ct.vec_reset(ct.home_keys(7, 13, dev), small)
  vc = ct.vec_reset(ct.home_keys(7, 13, 'cpu'), small)
  for g in range(3):
    a = draw(13)
    va, oa, fa = ct.vec_step_group_obs(va, a, small, 4, core)
    vc, oc, fc = ct.vec_step_group_obs(vc, a.cpu(), small, 4, core_cpu)
    if (max_err(va, vc, f'pixel group {g} vs CPU')
        or max_err(oa, oc, 'pixel outs vs CPU')
        or max_err(fa, fc, 'pixel frames vs CPU')):
      fail(f'pixel path: the card and the CPU differ at 13 envs, group {g}')
  print(f'13 envs x 3 pixel groups: kernel path == plain path on the CPU, '
        f'frames included ({int(va.episode.sum())} episodes begun)',
        flush=True)

  ea = ct.VecEnv(13, small, seed=4, reset_batch=4, device=dev)
  ec = ct.VecEnv(13, small, seed=4, reset_batch=4, device='cpu')
  if max_err(ea.reset(), ec.reset(), 'VecEnv reset frames'):
    fail('VecEnv.reset: the card and the CPU differ')
  for t in range(30):
    a = draw(13)[0]
    ra, rc = ea.step(a), ec.step(a.cpu())
    if any(max_err(x, y, f'VecEnv tick {t}') for x, y in zip(ra, rc)):
      fail(f'VecEnv.step: the card and the CPU differ at tick {t}')
  print(f'13 envs x 30 VecEnv ticks: card == CPU, obs, reward, done and '
        f'info ({int(ea.state.episode.sum())} episodes begun)', flush=True)

  # Env, the single-env Gym surface, on the card against the CPU: two
  # episodes of 30 ticks, frames, rewards, flags and info equal, and one
  # render at 512x512 (the render kernel's global instantiation).
  zero_counts()
  ga = ct.Env(seed=5, length=30, device=dev)
  gc = ct.Env(seed=5, length=30, device='cpu')
  if not (ga.reset() == gc.reset()).all():
    fail('Env.reset: the card and the CPU differ')
  episodes, ticks = 0, 0
  while episodes < 2:
    action = int(draw(1)[0, 0])
    (oa, ra, da, ia), (oc, rc, dc, ic) = ga.step(action), gc.step(action)
    same = (oa == oc).all() and (ra, da) == (rc, dc) and ia.keys() == ic.keys()
    for name, value in ic.items():
      same = same and (bool((ia[name] == value).all())
                       if hasattr(value, 'shape') else ia[name] == value)
    if not same:
      fail(f'Env.step: the card and the CPU differ at tick {ticks}')
    ticks += 1
    if da:
      episodes += 1
      if not (ga.reset() == gc.reset()).all():
        fail('Env.reset: the card and the CPU differ after an episode')
  if not (ga.render((512, 512)) == gc.render((512, 512))).all():
    fail('Env.render at 512x512: the card and the CPU differ')
  env_counts = read_counts('Env', ('tick', 'render_win79', 'noise2',
                                   'threefry'))
  print(f'Env, {ticks} ticks over 2 episodes and a 512x512 render: card == '
        f'CPU, obs, reward, done and info (launches {env_counts})',
        flush=True)
  del ga, gc

  all_steps = torch.arange(0, 20001, dtype=torch.int32)
  for day_length in (200, 300):
    if not torch.equal(ct.daylight(all_steps.to(dev), day_length).cpu(),
                       ct.daylight(all_steps, day_length)):
      fail(f'daylight on the card differs from the CPU\'s at day length '
           f'{day_length}')
  print('daylight (the kernel): card == CPU for steps 0..20000 at day '
        'lengths 200 and 300', flush=True)

  # The trained policy on the card against the CPU, from the same
  # parameters and frames (bfloat16 trunk on both).
  cpu_policy = ct.CnnPolicy(device='cpu')
  cpu_policy.load_state_dict(trained.state_dict())
  with torch.no_grad():
    on_card, on_cpu = trained(trained_obs), cpu_policy(trained_obs.cpu())
  policy_err = max(float((a.cpu() - b).abs().max())
                   for a, b in zip(on_card, on_cpu))
  print(f'policy forward, 256 frames: card vs CPU max |diff| {policy_err:.5f} '
        f'(logits up to {float(on_cpu.logits.abs().max()):.3f})', flush=True)
  if not policy_err <= POLICY_ATOL:
    fail('the policy on the card disagrees with the CPU')

  # A checkpoint written on the card, restored into a fresh state, and one
  # more update from it: equal to the update taken without the round trip.
  # Deterministic algorithms, so that cuDNN's backward allows equality; the
  # grouped cadence (a rollout of K ticks), and an episode cap that ends
  # every episode inside the update after the checkpoint.
  torch.use_deterministic_algorithms(True, warn_only=True)
  tiny = ct.PPO(ct.EnvConfig(length=15), ct.PPOConfig(
      num_envs=64, rollout_len=k, epochs=2, minibatches=2, reset_batch=8),
      device=dev)
  ts, _ = tiny.train_step(tiny.init(ct.prng.key(1, dev)))
  with tempfile.TemporaryDirectory() as tmp:
    ck = ckpt_lib.Checkpointer(tmp)
    ck.save(ts.update, ts)
    ts_a, metrics_a = tiny.train_step(ts)
    want_params = {name: q.detach().clone()
                   for name, q in ts_a.params.named_parameters()}
    restored = ck.restore_latest(tiny.init(ct.prng.key(2, dev)))
  if restored.update != 1 or int(restored.vec.tick) != k:
    fail(f'checkpoint: restored update {restored.update}, tick '
         f'{int(restored.vec.tick)}')
  ts_b, metrics_b = tiny.train_step(restored)
  torch.use_deterministic_algorithms(False)
  got_params = dict(ts_b.params.named_parameters())
  ck_err = max(float((got_params[name].detach() - q).abs().max())
               for name, q in want_params.items())
  if (ck_err != 0 or max_err(ts_a.vec, ts_b.vec, 'checkpoint env')
      or not torch.equal(ts_a.obs, ts_b.obs)
      or not torch.equal(ts_a.key, ts_b.key)
      or float(metrics_a['loss']) != float(metrics_b['loss'])):
    fail(f'checkpoint: the update after the round trip differs (parameters '
         f'by {ck_err})')
  print(f'checkpoint on the card: 64 envs, saved after update 1, restored, '
        f'update 2 == update 2 without the round trip '
        f'({int(ts_b.vec.episode.sum()) - 64} episodes begun since)',
        flush=True)
  if int(ts_b.vec.episode.sum()) == 64:
    fail('checkpoint: no episode ended after the round trip')

  # 5. What the port adds for users beyond the batched paths.
  # C1. The 'compat' worldgen mode: the permutation-table OpenSimplex's
  # candidate sum is one launch of its kernel (no TPU kernel behind it: the
  # JAX package runs it as jnp ops), held to its twin at a reset pass's 320
  # worlds and timed; the worlds must equal the CPU's; then a reset of 4096
  # compat worlds and state-only groups on them.
  ccfg = dataclasses.replace(cfg, noise_mode='compat')
  ckeys = ct.prng.fold_in(ct.home_keys(11, RESET_BATCH, dev), 1)
  cpts = worldgen.channel_points3(ccfg, dev)
  cperm = noise.perm_from_key(ct.prng.split(ckeys, 3)[:, 0])
  tk, ms = timed(lambda: noise_cuda.noise3_perm(cpts, cperm), 10)
  perm_dev_ms = device_ms(lambda: noise_cuda.noise3_perm(cpts, cperm),
                          'noise3_perm_kernel')
  tt, plain_ms = timed(lambda: noise.noise3_total(cpts[None], cperm), 2)
  ndiff = int((tk.view(torch.int32) != tt.view(torch.int32)).sum())
  err = (tk - tt).abs().max().item()
  print(f'C1 noise3_perm at {RESET_BATCH} worlds x {cpts.shape[0]} points: '
        f'{ndiff} of {tk.numel()} values differ from noise3_total in their '
        f'bits, max |diff| {err}; field in [{float(tk.min()):.3f}, '
        f'{float(tk.max()):.3f}]; {ms:.3f} ms with the wrapper, device '
        f'{dev_str(perm_dev_ms)}, the twin {plain_ms:.3f} ms', flush=True)
  if ndiff or float(tk.abs().max()) < 50:
    fail('noise3_perm disagrees with noise3_total')
  triples = tk.numel() * len(noise.CANDIDATES)
  rows.append(dict(
      name='noise3_perm', source='crafter_tpu_torch/csrc/noise3_perm.cu',
      replaces='none (crafter_tpu/ops/noise.py:noise3, jnp ops)',
      max_abs_err=err, ms=ms, plain_ms=plain_ms,
      bytes=cpts.numel() * 4 + cperm.numel() * 4 + tk.numel() * 4,
      ops=cpts.shape[0] * OPS_NOISE3_PERM_POINT
      + triples * OPS_NOISE3_PERM_TRIPLE,
      library_ms=None, device_ms=perm_dev_ms))
  del cpts, cperm, tk, tt
  before = noise_cuda.noise3_perm.launches
  wk = worldgen.generate_world(ckeys, ccfg)
  if noise_cuda.noise3_perm.launches != before + 1:
    fail('compat worldgen on the card did not launch noise3_perm once')
  t0 = time.perf_counter()
  wc = worldgen.generate_world(ckeys.cpu(), ccfg)
  compat_cpu_s = time.perf_counter() - t0
  if max_err(wk, wc, 'compat worldgen card vs CPU') != 0:
    fail(f'{RESET_BATCH} compat worlds made on the card differ from the '
         'CPU\'s')
  if len(torch.unique(wk.mat_map)) < 8 or int((wk.ent.etype > 1).sum()) == 0:
    fail('compat worlds: too few materials or no mob')
  print(f'C1 compat worldgen: {RESET_BATCH} worlds on the card == on the CPU '
        f'(the CPU took {compat_cpu_s:.1f} s)', flush=True)
  del wk, wc
  zero_counts()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  cvs = ct.vec_reset_chunked(ct.home_keys(12, N_ENVS, dev), ccfg)
  torch.cuda.synchronize()
  compat_reset_s = time.perf_counter() - t0
  if noise_cuda.noise2.launches:
    fail('the compat reset went through the 2-D noise kernel')
  if not noise_cuda.noise3_perm.launches:
    fail('the compat reset did not go through noise3_perm')
  done = torch.rand(N_ENVS, generator=gen, device=dev) < 0.1
  reset_pass_ms = {}
  for name, rcfg in (('auto', cfg), ('compat', ccfg), ('auto again', cfg),
                     ('compat again', ccfg)):
    _, reset_pass_ms[name] = timed(lambda: env_lib._reset_pass(
        cvs.env, done, cvs.episode, cvs.home_key, rcfg, RESET_BATCH), 3)
  compat_profile = profile(lambda: env_lib._reset_pass(
      cvs.env, done, cvs.episode, cvs.home_key, ccfg, RESET_BATCH), 2,
      'call', 'compat reset pass')
  auto_profile = profile(lambda: env_lib._reset_pass(
      cvs.env, done, cvs.episode, cvs.home_key, cfg, RESET_BATCH), 2,
      'call', 'auto reset pass')
  print(f'C1 reset pass of {RESET_BATCH} worlds on {card} (events, one '
        f'process, in turns): ' + ', '.join(
            f'{name} {ms:.2f} ms' for name, ms in reset_pass_ms.items())
        + f'; vec_reset_chunked of {N_ENVS} compat envs {compat_reset_s:.2f} '
        's', flush=True)
  zero_counts()
  cvs, _ = ct.vec_step_group(cvs, draw(N_ENVS), ccfg, RESET_BATCH)  # warm-up
  cvs0 = cvs
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  cdone = 0
  for _ in range(3):
    cvs, outs = ct.vec_step_group(cvs, draw(N_ENVS), ccfg, RESET_BATCH)
    cdone = cdone + outs.ended.sum()
  end.record()
  torch.cuda.synchronize()
  compat_ms = start.elapsed_time(end) / 3
  check_advanced(cvs, cvs0, 3 * k, 'compat state-only')
  compat_counts = read_counts('compat state-only', ('group_tick', 'balance',
                                                    'threefry', 'noise3_perm'))
  if compat_counts['noise2']:
    fail('the compat path launched the 2-D noise kernel')
  print(f'C1 compat state-only path on {card}: 3 groups x {k} ticks x '
        f'{N_ENVS} envs, {compat_ms:.2f} ms/group '
        f'({N_ENVS * k / (compat_ms / 1e3):,.0f} env-steps/s, '
        f'{int(cdone)} episodes ended; launches {compat_counts})',
        flush=True)
  del cvs, cvs0, done, outs
  torch.cuda.empty_cache()
  small_c = dataclasses.replace(ccfg, length=25)
  va = ct.vec_reset(ct.home_keys(9, 13, dev), small_c)
  vc = ct.vec_reset(ct.home_keys(9, 13, 'cpu'), small_c)
  for g in range(3):
    a = draw(13)
    va, oa = ct.vec_step_group(va, a, small_c, 4)
    vc, oc = ct.vec_step_group(vc, a.cpu(), small_c, 4)
    if (max_err(va, vc, f'compat group {g} vs CPU plain')
        or max_err(oa, oc, 'compat outs vs CPU plain')):
      fail(f'compat, 13 envs: the kernel path on the card and the plain '
           f'path on the CPU differ at group {g}')
  if int(va.episode.sum()) <= 13:
    fail('compat, 13 envs: no episode ended')
  print(f'C1 13 compat envs x 3 groups: kernel path on the card == plain '
        f'path on the CPU ({int(va.episode.sum()) - 13} episodes begun)',
        flush=True)

  # C2. ParityEnv, numpy on the host: the digest of a seeded rollout
  # (tests/parity_digest.py), which the CPU tests pin to the JAX
  # package's ParityEnv, on this machine's numpy and Python.
  import importlib.util
  import parity_digest
  t0 = time.perf_counter()
  digest, pcounts = parity_digest.rollout(ct.ParityEnv)
  parity_s = time.perf_counter() - t0
  libs = {m: importlib.util.find_spec(m) is not None
          for m in ('PIL', 'imageio')}
  if digest != parity_digest.DIGEST:
    fail(f'ParityEnv: digest {digest}, want {parity_digest.DIGEST}')
  if 'PIL' in sys.modules or 'imageio' in sys.modules:
    fail('ParityEnv imported an image library')
  print(f'C2 ParityEnv: {pcounts["steps"]} steps, {pcounts["episodes"]} '
        f'episodes begun, {pcounts["night"]} night and '
        f'{pcounts["sleeping"]} sleeping frames: digest equal to the JAX '
        f'package\'s; {pcounts["steps"] / parity_s:,.1f} steps/s on this '
        f'host (image libraries installed here: {libs}; none imported)',
        flush=True)

  # C3. The CLIs on the card.  run_terrain at its defaults (4 worlds viewed
  # whole at 1024 px): the render kernel on windows of 4048 values, its
  # image equal to the plain twin's (the CPU path) and its PNG inflating
  # to that image.
  import contextlib
  import io
  import struct
  import zlib
  from crafter_tpu_torch import run_random, run_terrain
  zero_counts()
  with tempfile.TemporaryDirectory() as tmp:
    png_path = Path(tmp) / 'terrain.png'
    t0 = time.perf_counter()
    grid = run_terrain.main(['--filename', str(png_path)])
    terrain_s = time.perf_counter() - t0
    data = png_path.read_bytes()
  terrain_counts = read_counts('run_terrain', ('render_win79', 'noise2',
                                               'threefry'))
  plain_grid = run_terrain.terrain_grid(4, 4, (64, 64), 1024, 0, 'cpu')
  if grid.shape != (1024, 4096, 3) or not (grid == plain_grid).all():
    fail('run_terrain: the card\'s image differs from the plain twin\'s')
  pos, idat = 8, b''
  while pos < len(data):
    (length,), kind = struct.unpack('>I', data[pos:pos + 4]), \
        data[pos + 4:pos + 8]
    if kind == b'IDAT':
      idat += data[pos + 8:pos + 8 + length]
    pos += 12 + length
  png_rows = torch.frombuffer(bytearray(zlib.decompress(idat)),
                              dtype=torch.uint8).reshape(1024, 1 + 4096 * 3)
  if (png_rows[:, 0] != 0).any() or not (
      png_rows[:, 1:].reshape(1024, 4096, 3).numpy() == grid).all():
    fail('run_terrain: the PNG does not inflate to the image')
  print(f'C3 run_terrain at its defaults: {terrain_s:.2f} s, image == plain '
        f'twin (CPU), PNG ({len(data)} bytes) inflates to it; launches '
        f'{terrain_counts}', flush=True)
  tenv = ct.Env(area=(64, 64), view=(64, 64), size=(1024, 1024), seed=0,
                device=dev)
  tenv.reset()
  st, tcfg, tatlas = tenv._state, tenv.cfg, tenv._core.atlas
  twin = render_lib.window_prep(
      step_lib.pack_cells(st.mat_map, st.ent.etype, st.ent.aux,
                          st.ent.facing),
      st.player.pos, st.player.facing, st.player.sleeping,
      st.player.inventory, tcfg)
  targs = (twin, ct.daylight(st.step, tcfg.day_length), st.player.sleeping,
           render_lib.noise_seed(st.key, st.step), tatlas)
  tframe, tms = timed(lambda: render_cuda.render_win79(
      *targs, tcfg.size, 'frames'), 5)
  tdev = device_ms(lambda: render_cuda.render_win79(*targs, tcfg.size,
                                                    'frames'),
                   'render_kernel')
  tplain, tplain_ms = timed(lambda: render_lib.render_win79_plain(*targs), 3)
  terr = float((tframe.to(torch.int16) - render_lib.format_pixels(
      tplain, tcfg.size, 'frames').to(torch.int16)).abs().max())
  print(f'C3 render_win79 on a whole-area window ({twin.shape[1]} values, '
        f'{tcfg.size[0]}x{tcfg.size[1]}, '
        f'{"shared" if render_cuda.occupancy(tatlas)[0] else "global"} '
        f'tables): {tms:.3f} ms (device {dev_str(tdev)}, plain '
        f'{tplain_ms:.3f} ms), max |diff| {terr}', flush=True)
  if terr != 0:
    fail('render_win79 on the whole-area window disagrees with the twin')
  tpix = tatlas.src.shape[0]
  rows.append(dict(
      name='render_win79_terrain', source='crafter_tpu_torch/csrc/render.cu',
      replaces='crafter_tpu/render.py:567', max_abs_err=terr, ms=tms,
      plain_ms=tplain_ms,
      bytes=twin.numel() * 4 + 12 + tpix * 3 + sum(
          t.numel() * t.element_size() for _, t in leaves(tatlas.compact)
          if isinstance(t, torch.Tensor)),
      ops=(tpix * OPS_RENDER_TEXEL + int(tatlas.view_mask.sum())
           * OPS_RENDER_LIGHT), library_ms=None, device_ms=tdev))
  del tenv, st, targs, tframe, tplain, grid, plain_grid, png_rows
  torch.cuda.empty_cache()

  def cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
      run_random.main(argv)
    print('\n'.join(f'  {line}' for line in out.getvalue().splitlines()),
          flush=True)
    return out.getvalue()

  zero_counts()
  text = cli(['--envs', str(N_ENVS), '--steps', str(100 * N_ENVS),
              '--seed', '3'])
  random_envs_counts = read_counts('run_random --envs', (
      'tick', 'balance', 'noise2', 'threefry', 'render_win79', 'daylight'))
  rate = re.search(r'\((\d+) env-steps/s\)', text)
  if not rate or random_envs_counts['tick'] != 100:
    fail(f'run_random --envs: {text!r}, launches {random_envs_counts}')
  print(f'C3 run_random --envs {N_ENVS} --steps {100 * N_ENVS} on {card}: '
        f'{int(rate.group(1)):,} env-steps/s; launches {random_envs_counts}',
        flush=True)
  zero_counts()
  with tempfile.TemporaryDirectory() as tmp:
    text = cli(['--steps', '200', '--length', '100', '--seed', '3',
                '--record', tmp])
    recorded = sorted(p.suffix for p in Path(tmp).iterdir())
    stats_rows = (Path(tmp) / 'stats.jsonl').read_text().splitlines()
  random_env_counts = read_counts('run_random', ('tick', 'render_win79',
                                                 'threefry'))
  if (len(stats_rows) != 2 or recorded.count('.gif') != 2
      or recorded.count('.npz') != 2 or 'Coal count:' not in text):
    fail(f'run_random --record: {recorded}, {len(stats_rows)} stats rows')
  print(f'C3 run_random, one env, 200 steps with --record: 2 episodes '
        f'recorded ({recorded}); launches {random_env_counts}', flush=True)

  # 6. Multi-device (crafter_tpu_torch.parallel).  D1: one NCCL rank in
  # this process.  The one-process runs go first, then the sharded ones
  # with the counts set to 0 just before.
  import torch.distributed as dist
  from crafter_tpu_torch.parallel import mesh as mesh_lib
  torch.cuda.empty_cache()
  d_start = time.perf_counter()
  d_cfg = dataclasses.replace(cfg, length=D_LENGTH)
  mesh_lib.distributed_init(f'127.0.0.1:{free_port()}', 1, 0,
                            backend='nccl')
  if dist.get_backend() != 'nccl' or dist.get_world_size() != 1:
    fail(f'D1: backend {dist.get_backend()}, {dist.get_world_size()} ranks')
  mesh = mesh_lib.dp_mesh()
  vs0 = ct.vec_reset_chunked(ct.home_keys(D_SEED, N_ENVS, dev), d_cfg)
  want, vs = [], vs0
  for g in range(D_GROUPS):
    vs, outs = ct.vec_step_group(vs, d_actions(ct.prng, g, k, N_ENVS, dev),
                                 d_cfg, RESET_BATCH)
    want.append((vs, outs))
  zero_counts()
  sstep = mesh_lib.make_sharded_group_step(mesh, d_cfg, RESET_BATCH)
  vs = mesh_lib.shard_batch(vs0, mesh, N_ENVS)
  got = []
  for g in range(D_GROUPS):
    vs, outs = sstep(vs, d_actions(ct.prng, g, k, N_ENVS, dev,
                                   mesh.rows(N_ENVS)))
    got.append((vs, outs))
  torch.cuda.synchronize()
  d1_group_counts = read_counts('D1 sharded group', ('group_tick', 'balance',
                                                     'noise2', 'threefry'))
  for g, ((va, oa), (vb, ob)) in enumerate(zip(got, want)):
    if max_err(va, vb, f'D1 group {g}') or max_err(oa, ob, f'D1 outs {g}'):
      fail(f'D1: the sharded group step differs from vec_step_group at '
           f'group {g}')
  if int(vs.pending.sum()) == 0 or int(vs.episode.sum()) <= N_ENVS:
    fail('D1: no reset pass overflowed its budget')
  hp = vs.env.player.inventory[:, 0]
  total = mesh_lib.psum_stats({'health': hp, 'ranks': 1}, mesh)
  if not torch.equal(total['health'], hp) or int(total['ranks']) != 1:
    fail(f'D1: psum_stats through NCCL gave {total}')
  del want, got, vs0, vs, va, vb, oa, ob, outs
  vcfg = dataclasses.replace(ct.EnvConfig(), length=D_LENGTH)
  v_acts = [ct.prng.randint(ct.prng.fold_in(ct.prng.key(D_SEED + 1, dev), t),
                            0, 17, (N_ENVS,)) for t in range(D_VECENV_TICKS)]
  plain_env = ct.VecEnv(N_ENVS, vcfg, seed=D_SEED, device=dev)
  want = [plain_env.reset()] + [plain_env.step(a) for a in v_acts]
  sharded_env = ct.VecEnv(N_ENVS, vcfg, seed=D_SEED, device=dev,
                          sharding=mesh)
  got = [sharded_env.reset()]
  zero_counts()                 # count the sharded steps' launches only
  got += [sharded_env.step(a) for a in v_acts]
  torch.cuda.synchronize()
  d1_env_counts = read_counts('D1 sharded VecEnv', (
      'tick', 'balance', 'noise2', 'threefry', 'render_win79', 'daylight'))
  for t, (a, b) in enumerate(zip(got, want)):
    pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
    if any(max_err(x, y, f'D1 VecEnv tick {t}') for x, y in pairs):
      fail(f'D1: the sharded VecEnv differs from VecEnv at tick {t}')
  if int(sharded_env.state.episode.sum()) <= N_ENVS:
    fail('D1: no VecEnv episode reset')
  d1_pending = int(sharded_env.state.pending.sum())
  del plain_env, sharded_env, want, got
  dist.barrier()
  dist.destroy_process_group()
  d1_s = time.perf_counter() - d_start
  print(f'D1 one NCCL rank on {card}: sharded group step, {N_ENVS} envs x '
        f'{D_GROUPS} groups == vec_step_group (launches {d1_group_counts}); '
        f'psum_stats through NCCL; sharded VecEnv x {D_VECENV_TICKS} ticks == '
        f'VecEnv, obs, reward, done, info ({d1_pending} envs pending at the '
        f'end; launches {d1_env_counts}); {d1_s:.1f} s', flush=True)
  torch.cuda.empty_cache()

  def run_ranks(what, argv_of_rank, world=2):
    """Start ``world`` ranks, each a subprocess, and wait for them (with a
    timeout); a rank that fails or times out fails the phase."""
    procs = [subprocess.Popen([sys.executable] + argv_of_rank(r),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=root)
             for r in range(world)]
    outs = []
    try:
      for p in procs:
        outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
      fail(f'{what}: a rank took more than {RANK_TIMEOUT} s')
    finally:
      for p in procs:
        if p.poll() is None:
          p.kill()
          p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
      if p.returncode != 0:
        fail(f'{what}: rank {r} exited with {p.returncode}:\n{out[-3000:]}')
    return outs

  def rank_results(outs):
    return [json.loads(next(line[len('RESULT '):]
                            for line in out.splitlines()
                            if line.startswith('RESULT ')))
            for out in outs]

  def need_launches(what, counts, needed):
    for name in needed:
      if not counts.get(name):
        fail(f'kernel {name} was not launched on {what}')

  # D2: two gloo ranks on the one card, 2048 envs each, per-rank budgets
  # that overflow; the gathered leaves against vec_step_group on each half.
  t0 = time.perf_counter()
  port = free_port()
  d2 = rank_results(run_ranks('D2', lambda r: [
      str(Path(__file__).resolve()), '--rank', 'group', str(r), '2',
      str(port)]))
  for r, res in enumerate(d2):
    need_launches(f'D2 rank {r}', res['launches'],
                  ('group_tick', 'balance', 'noise2', 'threefry'))
  if d2[0]['diffs']:
    fail(f'D2: the two ranks differ from vec_step_group on each half: '
         f'{d2[0]["diffs"][:10]}')
  if not all(res['pending'] for res in d2):
    fail(f'D2: a rank\'s reset budget did not overflow: {d2}')
  d2_s = time.perf_counter() - t0
  print(f'D2 two gloo ranks on {card}: 4096 envs x {D_GROUPS} groups, '
        f'per-rank budgets overflowed ({[res["pending"] for res in d2]} '
        f'pending), gathered leaves == vec_step_group on each half '
        f'({d2[0]["episodes"]} episodes begun); launches '
        f'{[res["launches"] for res in d2]}; {d2_s:.1f} s', flush=True)

  # D3: the config-4 runner at 65,536 envs, one NCCL rank in this process,
  # then two gloo ranks.
  t0 = time.perf_counter()
  demo = runpy.run_path(str(root / 'tools' / 'demo_64k_cuda.py'),
                        run_name='demo_64k_cuda')
  demo_args = ['--num_envs', str(DEMO_ENVS), '--steps', str(DEMO_STEPS)]
  # Each record holds the launches of its timed loop (the tool sets the
  # counts to 0 after its reset and warm-up).
  demo_one = demo['main'](demo_args + [
      '--coordinator', f'127.0.0.1:{free_port()}', '--num_processes', '1',
      '--process_id', '0', '--backend', 'nccl'])[0]
  d3_counts = demo_one['launches']
  del demo
  torch.cuda.empty_cache()
  port = free_port()
  outs = run_ranks('D3', lambda r: [
      str(root / 'tools' / 'demo_64k_cuda.py')] + demo_args + [
          '--coordinator', f'127.0.0.1:{port}', '--num_processes', '2',
          '--process_id', str(r), '--backend', 'gloo'])
  demo_two = [json.loads([line for line in out.splitlines()
                          if line.startswith('{')][-1]) for out in outs]
  for want_ranks, recs in ((1, [demo_one]), (2, demo_two)):
    for rec in recs:
      if (rec['processes'] != want_ranks or rec['devices'] != want_ranks
          or rec['num_envs'] != DEMO_ENVS or rec['steps'] != DEMO_STEPS
          or not rec['value'] > 0):
        fail(f'D3: record {rec}')
  need_launches('D3 one NCCL rank', d3_counts,
                ('group_tick', 'balance', 'noise2', 'threefry'))
  for r, rec in enumerate(demo_two):
    need_launches(f'D3 rank {r}', rec['launches'],
                  ('group_tick', 'balance', 'noise2', 'threefry'))
    print(f'D3 demo_64k_cuda.py, two gloo ranks on {card}, rank {r}: '
          f'{json.dumps(rec)}', flush=True)
  d3_s = time.perf_counter() - t0
  print(f'D3 demo_64k_cuda.py at {DEMO_ENVS} envs on {card}: one NCCL rank '
        f'{demo_one["value"]:,} env-steps/s (launches {d3_counts}), two gloo '
        f'ranks sharing the card {demo_two[0]["value"]:,} env-steps/s '
        f'(printed, not compared); {d3_s:.1f} s', flush=True)

  # D4: make_sharded_train on two gloo ranks at the training path's sizes.
  t0 = time.perf_counter()
  port = free_port()
  d4 = rank_results(run_ranks('D4', lambda r: [
      str(Path(__file__).resolve()), '--rank', 'train', str(r), '2',
      str(port)]))
  for r, res in enumerate(d4):
    need_launches(f'D4 rank {r}', res['launches'], (
        'tick', 'balance', 'noise2', 'threefry', 'render_win79', 'daylight'))
    if res['unchanged'] or res['update'] != 2 \
        or res['env_steps'] != 2 * PPO_ENVS * PPO_ROLLOUT \
        or res['local_envs'] != PPO_ENVS // 2:
      fail(f'D4 rank {r}: unchanged layers {res["unchanged"]}, update '
           f'{res["update"]}, env_steps {res["env_steps"]}')
  for u in range(2):
    a, b = d4[0]['updates'][u], d4[1]['updates'][u]
    if a['params'] != b['params']:
      fail(f'D4: the ranks\' parameters differ after update {u + 1}')
    if a['metrics'] != b['metrics'] or not all(
        math.isfinite(v) for v in a['metrics'].values()):
      fail(f'D4: metrics after update {u + 1}: {a["metrics"]} vs '
           f'{b["metrics"]}')
  small = d4[0]['small']
  if small['diffs'] or small['episodes_done'] != small['episodes_done_one']:
    fail(f'D4: the two-rank rollout of {D_SMALL_ENVS} envs differs from the '
         f'one-process PPO\'s: {small}')
  # The rate of the second update (the first warms cuDNN and the
  # allocator), on the slower rank's clock.
  second = [res['updates'][1] for res in d4]
  d4_sps = PPO_ENVS * PPO_ROLLOUT / (max(u['ms'] for u in second) / 1e3)
  d4_s = time.perf_counter() - t0
  split = [[f'{u["ms"]:.1f} (rollout {u["rollout_ms"]:.1f}, learn '
            f'{u["learn_ms"]:.1f}, of it {u["grad_sums"]} gradient '
            f'all-reduces {u["grad_sum_ms"]:.1f})' for u in res['updates']]
           for res in d4]
  print(f'D4 make_sharded_train, two gloo ranks on {card}: {PPO_ENVS} envs '
        f'x {PPO_ROLLOUT} ticks, {PPO_EPOCHS} epochs x {PPO_MINIBATCHES} '
        f'minibatches, update ms by rank {split}; the second update '
        f'{d4_sps:,.0f} env-steps/s (ranks sharing the card; one process, '
        f'phase 3d: {ppo_sps:,.0f}); parameters equal across ranks after '
        f'each update, metrics {d4[0]["updates"][-1]["metrics"]}; '
        f'{D_SMALL_ENVS} envs x {D_SMALL_TICKS} ticks deterministic: rollout '
        f'== one-process PPO ({small["episodes_done"]} episodes); launches '
        f'{[res["launches"] for res in d4]}; {d4_s:.1f} s', flush=True)
  print(json.dumps({'multi_device': {
      'd1': {'group_launches': d1_group_counts, 'vecenv_launches':
             d1_env_counts, 'seconds': d1_s},
      'd2': {'ranks': d2, 'seconds': d2_s},
      'd3': {'one_nccl_rank': demo_one, 'one_rank_launches': d3_counts,
             'two_gloo_ranks': demo_two, 'seconds': d3_s},
      'd4': {'env_steps_per_s': d4_sps, 'ranks': d4, 'seconds': d4_s},
      'seconds': time.perf_counter() - d_start}}), flush=True)

  tools_rec = phase7(root, card, need_launches)
  measuring_rec = phase8(root, card, need_launches)

  paths = (state_counts, pixel_counts, tick_counts, ppo_counts)
  launches = {
      'group_tick': state_counts['group_tick'],
      'group_tick_snaps': pixel_counts['group_tick'],
      'tick': tick_counts['tick'] + ppo_counts['tick'],
      'balance': sum(cn['balance'] for cn in paths),
      'render_win79': pixel_counts['render_win79'],
      'render_win79_4096': tick_counts['render_win79']
      + ppo_counts['render_win79'],
      'noise3': tool_counts['noise3'], 'roll': tool_counts['roll'],
      'render_win79_terrain': terrain_counts['render_win79'],
      'noise3_perm': compat_counts['noise3_perm']}
  for worlds in NOISE_WORLDS:
    name = 'noise2' if worlds == RESET_BATCH else f'noise2_{worlds}'
    launches[name] = sum(cn[f'noise2_rows_{worlds}'] for cn in paths)
  other = sum(cn['noise2'] for cn in paths) - sum(
      launches[name] for name in launches if name.startswith('noise2'))
  if other:
    fail(f'{other} noise2 launches at a shape the table does not list')
  kernels = []
  for row in rows:
    bound_bytes = row.pop('bytes') / HBM_BYTES_PER_S * 1e3
    bound_ops = row.pop('ops') / CORE_OPS_PER_S * 1e3
    row.update(route='cuda', launches=launches[row['name']],
               bound_ms=max(bound_bytes, bound_ops),
               bound_by='bytes' if bound_bytes >= bound_ops else 'operations')
    kernels.append({key: row[key] for key in (
        'name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
        'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms', 'device_ms')})
    dev = row['device_ms']
    gap = '' if dev is None else (
        f', launches x (device ms - bound) '
        f'{row["launches"] * (dev - row["bound_ms"]):.1f} ms')
    print(f'{row["name"]} on {card}: {row["ms"]:.3f} ms, device '
          f'{dev_str(dev)} (plain {row["plain_ms"]:.3f} ms, bound '
          f'{row["bound_ms"]:.4f} ms by {row["bound_by"]}), '
          f'{row["launches"]} launches on the paths{gap}')
  print(json.dumps({
      'kernels': kernels, 'card': card,
      'env_steps_per_s': {'state_only': sps, 'pixel': pixel_sps,
                          'per_tick': tick_sps, 'training': ppo_sps},
      'training_ms': {'update': ppo_ms, 'rollout': ppo_rollout_ms,
                      'learn': ppo_ms - ppo_rollout_ms},
      'bench': bench_rec,
      'launches_by_path': {'state_only': state_counts, 'pixel': pixel_counts,
                           'per_tick': tick_counts, 'training': ppo_counts,
                           'noise3_and_roll_tool': tool_counts,
                           'bench': bench_counts, 'env': env_counts,
                           'compat_state_only': compat_counts,
                           'run_terrain': terrain_counts,
                           'run_random_envs': random_envs_counts,
                           'run_random_env': random_env_counts},
      'compat': {'reset_pass_ms': reset_pass_ms, 'ms_per_group': compat_ms,
                 'reset_pass_profile': compat_profile,
                 'auto_reset_pass_profile': auto_profile},
      'parity_steps_per_s': pcounts['steps'] / parity_s,
      'tools': tools_rec, 'measuring_tools': measuring_rec}))
  print(card)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  if sys.argv[1:2] == ['--rank']:
    rank_main(sys.argv[2:])
  else:
    main()
