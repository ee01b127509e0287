"""Episode recording as one tracker plus pluggable sinks.

The port's own copy of ``crafter_tpu/recorder.py`` (the port imports nothing
of the JAX package).  The reference nests five wrapper classes, each
re-implementing the reset/step bookkeeping (reference:
crafter/recorder.py:9-185).  Here a single :class:`Recorder` wrapper tracks
the episode once and fans completed-episode events out to independent
*sinks*; the reference's class names remain as one-sink conveniences because
downstream code constructs them directly.

The on-disk formats ARE the reference's — they feed the score pipeline and
are held equal to the JAX package's in tests/test_torch_recorder.py:

* ``stats.jsonl``: one ``{"length": L, "reward": R, "achievement_<name>":
  count}`` object per episode (crafter/recorder.py:53-66);
* ``<ts>-ach<N>-len<L>.gif`` episode videos: the JAX package writes mp4
  through imageio (gif without ffmpeg); the port imports no image library
  and writes the gif itself (:func:`write_gif`);
* ``<ts>-ach<N>-len<L>.npz`` transition dumps with flattened
  ``achievement_*`` / ``ainventory_*`` keys and a zero-filled first step
  (crafter/recorder.py:117-152, :155-185).

``VecStatsRecorder`` is the batched-path equivalent: it accumulates per-env
length/return on the host and emits identical ``stats.jsonl`` lines at
episode boundaries.
"""

from __future__ import annotations

import datetime
import json
import pathlib

import numpy as np


# ---------------------------------------------------------------------------
# Sinks: each consumes (transitions, summary) for one finished episode.
# ---------------------------------------------------------------------------


class StatsSink:
  """Appends one JSON line per episode to ``stats.jsonl``."""

  def __init__(self, directory):
    self._file = (_mkdir(directory) / 'stats.jsonl').open('a')

  def wants_frames(self):
    return False

  def episode_done(self, transitions, summary):
    row = {'length': summary['length'], 'reward': round(summary['return'], 1)}
    row.update({f'achievement_{k}': v
                for k, v in summary['achievements'].items()})
    self._file.write(json.dumps(row) + '\n')
    self._file.flush()


class VideoSink:
  """Writes the episode's render frames as an animated gif."""

  def __init__(self, directory, size=(512, 512)):
    self._directory = _mkdir(directory)
    self.size = size

  def wants_frames(self):
    return True

  def episode_done(self, transitions, summary):
    write_gif(self._directory / (summary['name'] + '.gif'), summary['frames'])


def write_gif(path, frames):
  """Write RGB frames (each (H, W, 3) uint8, one size) as a looping gif at
  ten frames a second.

  The palette is fixed, 256 colours of 3-3-2 bits: a pixel's index is
  ``(r >> 5) << 5 | (g >> 5) << 2 | b >> 6`` and index ``i`` shows
  ``(r3 * 255 // 7, g3 * 255 // 7, b2 * 255 // 3)``, so a decoded channel
  lies within one quantisation step (32 for red and green, 64 for blue) of
  the frame's.  The image data is LZW-coded by :func:`_lzw` (8-bit
  symbols, codes of 9 to 12 bits, a clear code when the table is full).
  """
  frames = [np.asarray(f, np.uint8) for f in frames]
  height, width = frames[0].shape[:2]
  level = np.arange(256)
  palette = np.stack([(level >> 5) * 255 // 7, ((level >> 2) & 7) * 255 // 7,
                      (level & 3) * 255 // 3], -1).astype(np.uint8)
  u16 = lambda v: int(v).to_bytes(2, 'little')
  out = bytearray(b'GIF89a' + u16(width) + u16(height) + bytes([0xF7, 0, 0]))
  out += palette.tobytes()
  # Loop forever (the NETSCAPE2.0 application extension).
  out += b'\x21\xFF\x0BNETSCAPE2.0\x03\x01' + u16(0) + b'\x00'
  for frame in frames:
    if frame.shape != (height, width, 3):
      raise ValueError(f'frame {frame.shape}: want ({height}, {width}, 3)')
    index = ((frame[..., 0] >> 5) << 5) | ((frame[..., 1] >> 5) << 2) \
        | (frame[..., 2] >> 6)
    out += b'\x21\xF9\x04\x00' + u16(10) + b'\x00\x00'
    out += b'\x2C' + u16(0) + u16(0) + u16(width) + u16(height) + b'\x00'
    data = _lzw(index.reshape(-1).tolist())
    out += b'\x08'
    for i in range(0, len(data), 255):
      out += bytes([len(data[i:i + 255])]) + data[i:i + 255]
    out += b'\x00'
  out += b'\x3B'
  pathlib.Path(path).write_bytes(bytes(out))


def _lzw(symbols):
  """GIF's LZW over 8-bit symbols: a clear code first, variable-width
  codes (the width grows when the next code would not fit, up to 12
  bits), a clear code when the table holds 4096 codes, the end code last;
  the codes packed least significant bit first."""
  clear, end = 256, 257
  codes, widths = [clear], [9]
  table, next_code, width = {}, 258, 9
  prefix = symbols[0]
  for symbol in symbols[1:]:
    key = prefix << 8 | symbol
    code = table.get(key)
    if code is not None:
      prefix = code
      continue
    codes.append(prefix)
    widths.append(width)
    if next_code < 4096:
      if next_code >= 1 << width:
        width += 1
      table[key] = next_code
      next_code += 1
    else:
      codes.append(clear)
      widths.append(width)
      table, next_code, width = {}, 258, 9
    prefix = symbol
  codes.append(prefix)
  widths.append(width)
  if next_code >= 1 << width and width < 12:
    width += 1
  codes.append(end)
  widths.append(width)
  codes, widths = np.array(codes, np.int64), np.array(widths, np.int64)
  start = np.cumsum(widths) - widths
  owner = np.repeat(np.arange(codes.size), widths)
  bit = np.arange(int(widths.sum())) - start[owner]
  bits = ((codes[owner] >> bit) & 1).astype(np.uint8)
  return np.packbits(bits, bitorder='little').tobytes()


class TransitionSink:
  """Writes the full transition arrays as a compressed ``.npz``.

  Keys per step: action/image/reward/done, every scalar info entry,
  flattened ``achievement_*`` and ``ainventory_*`` counts.  The reset row
  carries only the image; the remaining keys are zero-filled to match the
  reference's array stacking (crafter/recorder.py:145-148).
  """

  def __init__(self, directory):
    self._directory = _mkdir(directory)

  def wants_frames(self):
    return False

  def episode_done(self, transitions, summary):
    first, rest = transitions[0], transitions[1:]
    if not rest:
      return
    template = rest[0]
    columns = {}
    for key in template:
      rows = [t.get(key, np.zeros_like(template[key])) for t in transitions]
      columns[key] = np.array(rows)
    np.savez_compressed(
        str(self._directory / (summary['name'] + '.npz')), **columns)


# ---------------------------------------------------------------------------
# The tracker/wrapper.
# ---------------------------------------------------------------------------


class Recorder:
  """Env wrapper: track each episode once, fan out to sinks on done.

  Mirrors the reference's composition root (crafter/recorder.py:9-25):
  ``directory`` plus three booleans select the standard sinks; pass
  ``sinks=[...]`` for custom ones (a sink whose ``wants_frames()`` is true
  gets the episode's ``env.render(video_size)`` frames).
  """

  def __init__(self, env, directory, save_stats=True, save_video=True,
               save_episode=True, video_size=(512, 512), sinks=None):
    self._env = env
    if sinks is None:
      sinks = []
      if directory and save_stats:
        sinks.append(StatsSink(directory))
      if directory and save_video:
        sinks.append(VideoSink(directory, video_size))
      if directory and save_episode:
        sinks.append(TransitionSink(directory))
    self._sinks = sinks
    self._want_frames = any(s.wants_frames() for s in sinks)
    self._frame_size = video_size
    self._transitions = None
    self._frames = None

  def __getattr__(self, name):
    if name.startswith('__'):
      raise AttributeError(name)
    return getattr(self._env, name)

  def reset(self):
    obs = self._env.reset()
    self._transitions = [{'image': np.asarray(obs)}]
    self._frames = ([np.asarray(self._env.render(self._frame_size))]
                    if self._want_frames else None)
    return obs

  def step(self, action):
    obs, reward, done, info = self._env.step(action)
    row = {'action': action, 'image': np.asarray(obs),
           'reward': reward, 'done': done}
    for key, value in info.items():
      if key == 'achievements':
        row.update({f'achievement_{k}': v for k, v in value.items()})
      elif key == 'inventory':
        row.update({f'ainventory_{k}': v for k, v in value.items()})
      else:
        row[key] = value
    self._transitions.append(row)
    if self._want_frames:
      self._frames.append(np.asarray(self._env.render(self._frame_size)))
    if done:
      self._flush(info)
    return obs, reward, done, info

  def _flush(self, info):
    achievements = dict(info['achievements'])
    length = len(self._transitions) - 1
    summary = dict(
        length=length,
        achievements=achievements,
        name=_episode_name(length, achievements),
        frames=self._frames,
        # Episode return sums info['reward'] (which overwrote the step
        # reward in each row — the same key collision the reference has,
        # crafter/recorder.py:58-62 + :139-144), so NoReward envs still
        # report real returns.
        **{'return': float(sum(float(t['reward'])
                               for t in self._transitions[1:]))})
    for sink in self._sinks:
      sink.episode_done(self._transitions, summary)


def _episode_name(length, achievements):
  """``{timestamp}-ach{N}-len{L}`` (crafter/recorder.py:183-185)."""
  timestamp = datetime.datetime.now().strftime('%Y%m%dT%H%M%S')
  unlocked = sum(int(v >= 1) for v in achievements.values())
  return f'{timestamp}-ach{unlocked}-len{length}'


def _mkdir(directory):
  path = pathlib.Path(directory).expanduser()
  path.mkdir(exist_ok=True, parents=True)
  return path


# ---------------------------------------------------------------------------
# Reference-shaped conveniences: one wrapper per sink.
# ---------------------------------------------------------------------------


def StatsRecorder(env, directory):
  """Stats-only recorder (crafter/recorder.py:28-66 surface)."""
  return Recorder(env, directory, sinks=[StatsSink(directory)])


def VideoRecorder(env, directory, size=(512, 512)):
  """Video-only recorder (crafter/recorder.py:69-99 surface)."""
  return Recorder(env, directory, video_size=size,
                  sinks=[VideoSink(directory, size)])


def EpisodeRecorder(env, directory):
  """Transition-dump-only recorder (crafter/recorder.py:102-152 surface)."""
  return Recorder(env, directory, sinks=[TransitionSink(directory)])


class VecStatsRecorder:
  """Batched-path stats: one ``stats.jsonl`` line per finished episode.

  Feed it each step's ``(reward, done, achievements)`` batch as host numpy
  arrays (``tensor.cpu().numpy()``); episode returns accumulate the reward
  signal exactly like the single-env stats sink.
  """

  def __init__(self, num_envs: int, directory):
    from . import rules
    self._names = rules.ACHIEVEMENTS
    self._sink = StatsSink(directory)
    self._length = np.zeros((num_envs,), np.int64)
    self._return = np.zeros((num_envs,), np.float64)

  def add(self, reward, done, achievements, ended=None):
    """Record one step's batch.

    ``ended`` (info['ended'], one pulse per finished episode) selects which
    envs emit a stats line; it defaults to ``done``, which is only correct
    when no env ever waits for an auto-reset slot — VecEnv latches ``done``
    true while waiting, and emitting on it would re-count the episode.
    Accumulators reset on the latched ``done`` either way, so waiting
    ticks never leak into the next episode.
    """
    reward = np.asarray(reward)
    done = np.asarray(done)
    ended = done if ended is None else np.asarray(ended)
    self._length += 1
    self._return += reward
    if ended.any():
      achievements = np.asarray(achievements)
      for i in np.flatnonzero(ended):
        self._emit(int(self._length[i]), float(self._return[i]),
                   achievements[i])
    if done.any():
      self._length[done] = 0
      self._return[done] = 0.0

  def add_episodes(self, count, lengths, returns, achievements):
    """Drain an on-device episode buffer (ppo.PPO._episode_stats).

    The accumulators live in the training state in this mode; only
    finished rows cross to the host, once per update.
    """
    count = int(count)
    lengths = np.asarray(lengths)[:count]
    returns = np.asarray(returns)[:count]
    achievements = np.asarray(achievements)[:count]
    for i in range(count):
      self._emit(int(lengths[i]), float(returns[i]), achievements[i])

  def _emit(self, length, ret, ach_row):
    self._sink.episode_done(None, dict(
        length=length,
        achievements={name: int(ach_row[j])
                      for j, name in enumerate(self._names)},
        **{'return': ret}))
