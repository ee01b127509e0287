"""Micro-bench: packed int32 RGB lanes -> NHWC uint8 frames, on one GPU.

The counterpart of ``tools/bench_unpack.py`` for ``crafter_tpu_torch``.
The pixel path's last stage turns (B, C) int32 ``r | g<<8 | b<<16`` lanes
into (B, H, W, 3) uint8 frames.  The JAX tool's two formulations, as plain
PyTorch functions:

  U0  bitcast -> (B, C, 4) u8 -> slice [..., :3] -> reshape (copied into
      a frame buffer: PyTorch would leave a strided view of the lanes)
  U1  int32 word compaction: 4 lanes into 3 words (the byte stream of the
      NHWC u8 buffer), then one bitcast; its right shifts are logical
      (``step.srl``), as ``jax.lax.shift_right_logical``

Checks ``U0 == U1`` bit for bit on the JAX tool's lanes
(``jax.random.randint(key(0), (n, 4096), 0, 1 << 24)``), then times
``ctl`` (the bitcast alone), U0 and U1 as the JAX tool does: 20 iterations
of ``o = fn(px ^ (s & 1)); s = o.to(int32).sum()``, best of 3, with the
JAX tool's lines.

The render kernel writes the three formats itself (``render_cuda.OUT_FORMATS``:
'frames', 'packed', 'words'), so the tool then renders n frames of real
windows once in each (``render.window_prep`` of ``vec_reset_chunked`` states
at ``min(n, 4096)`` envs, each env's window repeated, steps spread over a
day), checks ``frames == U0(packed) == words`` as bytes, and prints each
format's time with the wrapper beside U0 and U1 on the 'packed' lanes, and
the render kernel's launches.  On a GPU the card's name and power limit
follow.  ``main(argv)`` returns the record.

    python tools/bench_unpack_cuda.py [frames]          # 40960 on the GPU
    python tools/bench_unpack_cuda.py 16 --device cpu

``--device cpu`` runs the same code on the CPU (the render's plain twin);
without a GPU the default run stops with an error.
"""

import pathlib as _pathlib
import sys as _sys

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from crafter_tpu_torch.step import srl  # noqa: E402

SIZE = (64, 64)
ITERS = 20      # iterations of a timed loop, as the JAX tool
REPS = 3        # timed loops, best kept
RENDER_ENVS = 4096


def u0(px, size):
  b = px.contiguous().view(torch.uint8).reshape(px.shape + (4,))
  # The frames as a buffer of their own: the reshape alone would be a
  # strided view of the lanes.
  frames = b[..., :3].reshape(px.shape[:-1] + (size[1], size[0], 3))
  return frames.contiguous()


def u1(px, size):
  c = px.shape[-1]
  p0, p1, p2, p3 = px.reshape(px.shape[:-1] + (c // 4, 4)).unbind(-1)
  w0 = p0 | (p1 << 24)
  w1 = srl(p1, 8) | (p2 << 16)
  w2 = srl(p2, 16) | (p3 << 8)
  words = torch.stack([w0, w1, w2], -1).reshape(px.shape[:-1]
                                                 + (3 * c // 4,))
  return words.view(torch.uint8).reshape(px.shape[:-1]
                                         + (size[1], size[0], 3))


def ctl(px, size):
  return px.contiguous().view(torch.uint8).reshape(
      px.shape[:-1] + (size[1], size[0], 4))


def _timer(dev):
  """``timed(fn)``: ms of ``fn()`` (CUDA events on a GPU), and its value."""
  def timed(fn):
    if dev.type == 'cuda':
      start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
      start.record()
      out = fn()
      end.record()
      torch.cuda.synchronize(dev)
      return start.elapsed_time(end), out
    t0 = time.perf_counter()
    out = fn()
    if isinstance(out, torch.Tensor) and out.dim() == 0:
      int(out)
    return (time.perf_counter() - t0) * 1e3, out
  return timed


def best_ms(timed, fn, reps=REPS):
  """Best of ``reps`` timed calls after a warm-up, and the last value."""
  _, out = timed(fn)
  best = float('inf')
  for _ in range(reps):
    ms, out = timed(fn)
    best = min(best, ms)
  return best, out


def real_windows(n, dev):
  """The render kernel's inputs for n frames of real worlds: the windows,
  daylight, sleeping flags and noise seeds, and the atlas."""
  import crafter_tpu_torch as ct
  from crafter_tpu_torch import render
  cfg = ct.EnvConfig()
  envs = min(n, RENDER_ENVS)
  env = ct.vec_reset_chunked(ct.home_keys(0, envs, dev), cfg).env
  rows = torch.arange(n, device=dev) % envs
  p = env.player
  packed = ct.pack_cells(env.mat_map, env.ent.etype, env.ent.aux,
                         env.ent.facing)[rows]
  win = render.window_prep(packed, p.pos[rows], p.facing[rows],
                           p.sleeping[rows], p.inventory[rows], cfg)
  steps = (env.step[rows] + torch.arange(n, device=dev,
                                         dtype=torch.int32)) % cfg.day_length
  light = ct.daylight(steps, cfg.day_length)
  seeds = render.noise_seed(env.key[rows], steps)
  atlas = ct.bake_atlas(cfg.size, cfg.view, cfg.item_rows, dev)
  return (win, light, p.sleeping[rows], seeds), atlas


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('frames', type=int, nargs='?', default=40960)
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  from crafter_tpu_torch import prng, render_cuda
  from crafter_tpu_torch.utils import tool_device
  dev, card = tool_device(args.device, 'bench_unpack_cuda')
  n = args.frames
  c = SIZE[0] * SIZE[1]
  timed = _timer(dev)
  px = prng.randint(prng.key(0, dev), 0, 1 << 24, (n, c))

  if not torch.equal(u0(px, SIZE), u1(px, SIZE)):
    raise SystemExit(f'bench_unpack_cuda: U0 != U1 on {n} frames')
  print('U0 == U1 bitwise on', n, 'frames', flush=True)

  # As the JAX tool: every output byte summed, the input xored with a
  # carry-derived bit each iteration; 'ctl' prices the xor and sum.
  def loop(fn):
    s = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(ITERS):
      o = fn(px ^ (s & 1), SIZE)
      s = o.to(torch.int32).sum(dtype=torch.int32)
    return s

  loop_ms = {}
  for name, fn in (('ctl', ctl), ('U0', u0), ('U1', u1)):
    best, _ = best_ms(timed, lambda fn=fn: loop(fn))
    loop_ms[name] = best / ITERS
    print(f'{name}: {best / ITERS:.2f} ms / {n} frames (incl. xor+sum)',
          flush=True)
  del px

  # The render kernel's three formats on real windows.
  inputs, atlas = real_windows(n, dev)
  render_cuda.render_win79.launches = 0
  render_ms, out = {}, {}
  for fmt in render_cuda.OUT_FORMATS:
    render_ms[fmt], out[fmt] = best_ms(timed, lambda fmt=fmt: (
        render_cuda.render_win79(*inputs, atlas, SIZE, fmt)))
  launches = render_cuda.render_win79.launches if dev.type == 'cuda' else None
  lanes = out['packed']
  frames_u0 = u0(lanes, SIZE)
  if not (torch.equal(out['frames'], frames_u0)
          and torch.equal(u1(lanes, SIZE), frames_u0)
          and torch.equal(out['words'].view(torch.uint8).reshape(
              out['frames'].shape), out['frames'])):
    raise SystemExit(f'bench_unpack_cuda: the render formats disagree on {n} '
                     'frames')
  unpack_ms = {name: best_ms(timed, lambda fn=fn: fn(lanes, SIZE))[0]
               for name, fn in (('U0', u0), ('U1', u1))}
  print(f'render_win79 on {n} frames of real windows: frames == U0(packed) '
        '== U1(packed) == words, byte for byte', flush=True)
  print(f"render 'frames' {render_ms['frames']:.3f} ms, 'words' "
        f"{render_ms['words']:.3f} ms, 'packed' {render_ms['packed']:.3f} ms "
        f"+ U0 {unpack_ms['U0']:.3f} ms / + U1 {unpack_ms['U1']:.3f} ms (with "
        f'the wrapper, best of {REPS}); render launches {launches}',
        flush=True)
  if card:
    print(card, flush=True)
  return {'frames': n, 'loop_ms': loop_ms, 'render_ms': render_ms,
          'unpack_ms': unpack_ms, 'launches': launches, 'device': str(dev),
          'card': card}


if __name__ == '__main__':
  main()
