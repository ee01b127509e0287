"""Smoke test of the PyTorch/CUDA port on one GPU: build, check, drive.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

1. Builds the CUDA kernels of ``crafter_tpu_torch/csrc`` (nvcc, sm_90a).
2. Holds each kernel against its plain PyTorch twin on the card, on the
   same inputs at main-path shapes: the group tick and the balance at 4096
   envs (states reached by stepping fresh worlds), the noise on one reset
   pass of 320 worlds.  Integer outputs and rewards must be bitwise equal;
   noise must be bitwise equal or within NOISE_ATOL with no material of the
   320 worlds flipped.
3. Drives the main path: ``vec_reset_chunked`` of 4096 envs, then
   MAIN_GROUPS groups of ``vec_step_group`` (K = 10 ticks) with
   ``reset_batch = 320`` and actions from a CUDA generator; every env must
   have stepped the full count or reset, and each kernel's launch count
   must have risen during that run.  Prints env-steps/s (CUDA events).
   The same 320 worlds are made on the CPU too, and every leaf must equal
   the card's.
4. Runs the kernel path and the plain path on the card, and the CPU path,
   for 3 groups at 13 envs across episode ends and requires every leaf
   equal.

Prints the kernel table as one JSON line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line.  Any failed
phase raises, so the script exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

N_ENVS = 4096
RESET_BATCH = 320          # min(N, 10 * max(32, N // 128)), bench.py:57-58
WARM_GROUPS = 3            # groups stepped before the kernel checks
MAIN_GROUPS = 20
PROFILE_GROUPS = 3         # groups under torch.profiler for the breakdown
TOP_OPS = 12
NOISE_ATOL = 1e-6          # noise may differ from its twin by at most this
# H100 SXM peaks from NVIDIA's data sheet: memory rate, and the CUDA-core
# float32 rate, which the bound also applies to integer operations (a lower
# bound on their time: the int32 units are no faster).
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
# Operations the work needs per element, counted from the kernels' source
# where they do that work.  The group tick's mob phase is needed only for
# the active entities (etype > player within the update distance): two
# cell_bits hashes (~44), the move decision and target read (~60), the
# claim word, its resolution at the target and the move (~50), shooting,
# strikes and removals (~30); the kernel's own dense sweep over every cell
# is not work the function needs.  The player phase costs ~300 a tick per
# env.  The balance needs ~4 a cell to sort it into its chunk's counts;
# the noise ~250 a point (8 candidates of ~16 float and ~14 integer ops).
OPS_GROUP_TICK_ACTIVE = 180
OPS_GROUP_TICK_PLAYER = 300
OPS_BALANCE_CELL = 4
OPS_NOISE_POINT = 250


def fail(msg):
  raise SystemExit(f'chip_smoke: FAILED: {msg}')


def card_line():
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60).stdout
  return out.strip().splitlines()[0]


def main():
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
  from crafter_tpu_torch import worldgen
  from crafter_tpu_torch.ops import noise, noise_cuda
  from crafter_tpu_torch.state import leaves

  dev = torch.device('cuda')
  card = card_line()
  kind = torch.cuda.get_device_name(0)
  print(f'card: {card}', flush=True)

  # 1. Build.
  t0 = time.perf_counter()
  lib_path = _build.build()
  _build.library()
  print(f'build: {time.perf_counter() - t0:.1f} s -> {lib_path}', flush=True)
  ptxas = (lib_path.parent / 'ptxas.log').read_text()
  for line in ptxas.splitlines():
    if 'registers' in line or 'spill' in line or line.startswith('=='):
      print(f'  {line.strip()}')

  def timed(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
      out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps

  def to_device(obj, device):
    if dataclasses.is_dataclass(obj):
      return dataclasses.replace(obj, **{
          f.name: to_device(getattr(obj, f.name), device)
          for f in dataclasses.fields(obj)})
    return obj.to(device)

  def max_err(a, b, what):
    """Max |a - b| over matching leaves; raises if shapes or dtypes differ."""
    la, lb = leaves(a), leaves(b)
    worst = 0.0
    for (pa, x), (pb, y) in zip(la, lb):
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

  # 2. Each kernel against its plain twin at main-path shapes.
  vs = ct.vec_reset_chunked(ct.home_keys(1, N_ENVS, dev), cfg)
  for _ in range(WARM_GROUPS):
    vs, _ = ct.vec_step_group(vs, draw(N_ENVS), cfg, RESET_BATCH)
  acts = draw(N_ENVS)
  env = vs.env
  c = cfg.area[0] * cfg.area[1]
  rows = []

  got, ms = timed(lambda: step_cuda.group_tick(env, acts, cfg), 5)
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
  active, st = 0, env
  for t in range(k):
    pos = st.player.pos.long()
    pdist = (pos[:, :1] - cx).abs() + (pos[:, 1:] - cy).abs()
    active += int(((st.ent.etype > ct.rules.E_PLAYER)
                   & (pdist < cfg.update_distance)).sum())
    st = step_cuda.group_tick(st, acts[t:t + 1], cfg)[0]
  print(f'group_tick: {active} active entity-ticks in the group, '
        f'{active / (N_ENVS * c * k):.4%} of cell-ticks', flush=True)
  bytes_ = N_ENVS * c * (6 + 7) + 2 * N_ENVS * step_cuda.REC * 4 \
      + k * N_ENVS * (4 + 6)
  ops = active * OPS_GROUP_TICK_ACTIVE + N_ENVS * k * OPS_GROUP_TICK_PLAYER
  del st
  rows.append(dict(
      name='group_tick', source='crafter_tpu_torch/csrc/group_tick.cu',
      replaces='crafter_tpu/step.py:1373', max_abs_err=err, ms=ms,
      plain_ms=plain_ms, bytes=bytes_, ops=ops, library_ms=None))

  occ = got[2]
  s_bal = step_lib.tick_seeds(got[0].key, got[0].step)[2]
  bal, ms = timed(lambda: step_cuda.balance(got[0], s_bal, occ, cfg), 5)
  bref, plain_ms = timed(
      lambda: step_lib.balance_plain(got[0], s_bal, occ, cfg), 2)
  err = max_err(bal, bref, 'balance')
  if err != 0:
    fail('balance disagrees with balance_plain')
  changed = int((bal.ent.etype != got[0].ent.etype).sum())
  print(f'balance: {changed} cells changed by the pass', flush=True)
  if changed == 0:
    fail('the balance pass changed nothing: the check has no teeth')
  nch = cfg.n_chunks[0] * cfg.n_chunks[1]
  rows.append(dict(
      name='balance', source='crafter_tpu_torch/csrc/balance.cu',
      replaces='crafter_tpu/step.py:1114', max_abs_err=err, ms=ms,
      plain_ms=plain_ms, bytes=N_ENVS * c * (6 + 4) + N_ENVS * (2 * nch + 16),
      ops=N_ENVS * c * OPS_BALANCE_CELL, library_ms=None))

  keys = ct.prng.fold_in(ct.home_keys(2, RESET_BATCH, dev), 2)
  pts, seeds = worldgen.noise_inputs(keys, cfg)
  nz, ms = timed(lambda: noise_cuda.noise2(pts, seeds), 10)
  nref, plain_ms = timed(lambda: noise.noise2_fast(pts, seeds), 2)
  err = (nz - nref).abs().max().item()
  ndiff = int((nz != nref).sum())
  wk = worldgen.generate_world(keys, cfg)
  wp = worldgen.generate_world(keys, dataclasses.replace(cfg,
                                                         noise_mode='fast'))
  flips = int((wk.mat_map != wp.mat_map).sum())
  print(f'noise2: {ndiff} of {nz.numel()} values differ, max |diff| {err}, '
        f'{flips} materials flipped', flush=True)
  if err > NOISE_ATOL or flips != 0 or max_err(wk, wp, 'worldgen') != 0:
    fail('noise2 disagrees with noise2_fast')
  # The same worlds made on the CPU, where the tests hold them against the
  # reference: every leaf must be equal (the float32 math of the material
  # cascade gives the same bits on both devices).
  wc = worldgen.generate_world(keys.cpu(), cfg)
  if max_err(wk, to_device(wc, dev), 'worldgen card vs CPU') != 0:
    fail(f'{RESET_BATCH} worlds made on the card differ from the CPU\'s')
  print(f'worldgen: {RESET_BATCH} worlds on the card == on the CPU',
        flush=True)
  p = pts.shape[0]
  rows.append(dict(
      name='noise2', source='crafter_tpu_torch/csrc/noise2.cu',
      replaces='crafter_tpu/ops/noise_pallas.py:99', max_abs_err=err, ms=ms,
      plain_ms=plain_ms, bytes=p * (8 + 4 + 4), ops=p * OPS_NOISE_POINT,
      library_ms=None))
  del got, ref, bal, bref, nz, nref, wk, wp, pts, seeds, env, vs
  torch.cuda.empty_cache()

  # 3. The main path, counted and timed.
  wrappers = {'group_tick': step_cuda.group_tick,
              'balance': step_cuda.balance, 'noise2': noise_cuda.noise2}
  for fn in wrappers.values():
    fn.launches = 0
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  vs = ct.vec_reset_chunked(ct.home_keys(0, N_ENVS, dev), cfg)
  torch.cuda.synchronize()
  reset_s = time.perf_counter() - t0
  vs, _ = ct.vec_step_group(vs, draw(N_ENVS), cfg, RESET_BATCH)   # warm-up
  vs0 = vs
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  dones = 0
  for _ in range(MAIN_GROUPS):
    vs, outs = ct.vec_step_group(vs, draw(N_ENVS), cfg, RESET_BATCH)
    dones = dones + outs.ended.sum()
  end.record()
  torch.cuda.synchronize()
  main_ms = start.elapsed_time(end)
  launches = {name: fn.launches for name, fn in wrappers.items()}
  stepped = (vs.env.step - vs0.env.step) == MAIN_GROUPS * k
  reset = vs.episode > vs0.episode
  bad = int((~(stepped | reset)).sum())
  if bad:
    fail(f'{bad} envs neither stepped nor reset')
  for name, count in launches.items():
    if count == 0:
      fail(f'kernel {name} was not launched on the main path')
  sps = N_ENVS * k * MAIN_GROUPS / (main_ms / 1e3)
  print(f'main path on {card}: reset of {N_ENVS} envs {reset_s:.2f} s; '
        f'{MAIN_GROUPS} groups x {k} ticks x {N_ENVS} envs in '
        f'{main_ms:.1f} ms = {sps:,.0f} env-steps/s '
        f'({main_ms / MAIN_GROUPS:.2f} ms/group, {int(dones)} episodes '
        f'ended, launches {launches})', flush=True)

  # Where a group's time goes: the reset pass alone (CUDA events), and the
  # device's busy share and top operations over PROFILE_GROUPS groups.
  done = torch.rand(N_ENVS, generator=gen, device=dev) < 0.1
  _, reset_ms = timed(lambda: env_lib._reset_pass(
      vs.env, done, vs.episode, vs.home_key, cfg, RESET_BATCH), 3)
  print(f'reset pass of {RESET_BATCH} worlds on {card}: {reset_ms:.2f} ms',
        flush=True)
  acts = [draw(N_ENVS) for _ in range(PROFILE_GROUPS)]
  torch.cuda.synchronize()
  with torch.profiler.profile(activities=[
      torch.profiler.ProfilerActivity.CPU,
      torch.profiler.ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for a in acts:
      vs, _ = ct.vec_step_group(vs, a, cfg, RESET_BATCH)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  # Device-side entries only (kernels, copies): the host operators that
  # launched them report the same device time again.
  dev_us = lambda e: getattr(e, 'self_device_time_total', 0)
  events = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=dev_us, reverse=True)
  busy_ms = sum(dev_us(e) for e in events) / 1e3
  print(f'profile of {PROFILE_GROUPS} groups on {card}: wall {wall_ms:.1f} '
        f'ms, device busy {busy_ms:.1f} ms '
        f'({100 * busy_ms / wall_ms:.1f}%); top device time:', flush=True)
  for e in events[:TOP_OPS]:
    if dev_us(e) > 0:
      print(f'  {dev_us(e) / 1e3 / PROFILE_GROUPS:8.3f} ms/group '
            f'{e.count // PROFILE_GROUPS:5d}/group  {e.key[:70]}')

  # 4. Kernel path == plain path on the card == the CPU, across episode
  # ends.
  small = dataclasses.replace(cfg, length=25)
  plain = dataclasses.replace(small, engine='plain', noise_mode='fast')
  va = ct.vec_reset(ct.home_keys(9, 13, dev), small)
  vb = ct.vec_reset(ct.home_keys(9, 13, dev), plain)
  vc = ct.vec_reset(ct.home_keys(9, 13, 'cpu'), small)
  for g in range(3):
    a = draw(13)
    va, oa = ct.vec_step_group(va, a, small, 4)
    vb, ob = ct.vec_step_group(vb, a, plain, 4)
    vc, oc = ct.vec_step_group(vc, a.cpu(), small, 4)
    if max_err(va, vb, f'small group {g}') or max_err(oa, ob, 'small outs'):
      fail(f'kernel path and plain path differ at 13 envs, group {g}')
    if (max_err(va, to_device(vc, dev), f'small group {g} vs CPU')
        or max_err(oa, to_device(oc, dev), 'small outs vs CPU')):
      fail(f'the card and the CPU differ at 13 envs, group {g}')
  print(f'13 envs x 3 groups: kernel path == plain path == CPU '
        f'({int(va.episode.sum())} episodes begun, '
        f'{int(va.pending.sum())} pending)', flush=True)

  kernels = []
  for row in rows:
    bound_bytes = row.pop('bytes') / HBM_BYTES_PER_S * 1e3
    bound_ops = row.pop('ops') / CORE_OPS_PER_S * 1e3
    row.update(route='cuda', launches=launches[row['name']],
               bound_ms=max(bound_bytes, bound_ops),
               bound_by='bytes' if bound_bytes >= bound_ops else 'operations')
    kernels.append({key: row[key] for key in (
        'name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
        'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')})
    print(f'{row["name"]} on {card}: {row["ms"]:.3f} ms (plain '
          f'{row["plain_ms"]:.3f} ms, bound {row["bound_ms"]:.4f} ms by '
          f'{row["bound_by"]}), {row["launches"]} launches on the main path')
  print(json.dumps({'kernels': kernels, 'env_steps_per_s': sps,
                    'card': card}))
  print(card)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  main()
