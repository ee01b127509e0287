"""Human-play pygame GUI — a thin client over the single-env path.

Feature surface mirrors the reference CLI (reference: crafter/run_gui.py):
the WASD/SPACE/TAB + R/T/F/P + 1-6 keymap, fps clock, ``--death
{continue,reset,quit}``, ``--wait``, ``--record``, and the health override
via rule mutation.  The implementation is organized as a small session
object (draw / read-input / advance) rather than one monolithic loop.

    python -m crafter_tpu_torch.run_gui --device cpu

pygame is imported inside :func:`main` (a session is handed the module),
never when this module is imported.  Frames are scaled to the window with
the port's nearest-neighbour resize (PIL's ``Image.NEAREST``, reproduced).
"""

import argparse


KEYMAP_NAMES = {
    'a': 'move_left', 'd': 'move_right', 'w': 'move_up', 's': 'move_down',
    'space': 'do', 'tab': 'sleep',
    'r': 'place_stone', 't': 'place_table', 'f': 'place_furnace',
    'p': 'place_plant',
    '1': 'make_wood_pickaxe', '2': 'make_stone_pickaxe',
    '3': 'make_iron_pickaxe', '4': 'make_wood_sword',
    '5': 'make_stone_sword', '6': 'make_iron_sword',
}


class GuiSession:
  """One interactive play session: window, input, episode bookkeeping."""

  def __init__(self, env, args, pygame):
    self.env = env
    self.args = args
    self.pygame = pygame
    self.keymap = {pygame.key.key_code(name): action
                   for name, action in KEYMAP_NAMES.items()}
    self.screen = pygame.display.set_mode(args.window)
    self.clock = pygame.time.Clock()
    self.render_size = [args.size[0] or args.window[0],
                        args.size[1] or args.window[1]]
    self.running = True
    self._new_episode(reset=False)

  def _new_episode(self, reset=True):
    if reset:
      self.env.reset()
    self.unlocked = set()
    self.steps = 0
    self.episode_return = 0.0
    self.finished = False

  def print_keymap(self):
    print('Actions:')
    for key, action in self.keymap.items():
      print(f'  {self.pygame.key.name(key)}: {action}')

  def draw(self):
    frame = self.env.render(self.render_size)
    if self.render_size != list(self.args.window):
      from crafter_tpu_torch import render
      window = self.args.window
      frame = render._resize(frame, (window[1], window[0]))
    surface = self.pygame.surfarray.make_surface(frame.transpose(1, 0, 2))
    self.screen.blit(surface, (0, 0))
    self.pygame.display.flip()
    self.clock.tick(self.args.fps)

  def read_action(self):
    """One queued or held key -> action name; None if nothing pressed."""
    pg = self.pygame
    choice = None
    pg.event.pump()
    for event in pg.event.get():
      quit_ = event.type == pg.QUIT or (
          event.type == pg.KEYDOWN and event.key == pg.K_ESCAPE)
      if quit_:
        self.running = False
      elif event.type == pg.KEYDOWN and event.key in self.keymap:
        choice = self.keymap[event.key]
    if choice is None:
      held = pg.key.get_pressed()
      choice = next((a for k, a in self.keymap.items() if held[k]), None)
    return choice

  def advance(self, action):
    _, reward, done, info = self.env.step(
        self.env.action_names.index(action))
    self.steps += 1
    self.episode_return += reward
    for name, count in info['achievements'].items():
      if count > 0 and name not in self.unlocked:
        self.unlocked.add(name)
        print(f'Achievement ({len(self.unlocked)}'
              f'/{len(info["achievements"])}): {name}')
    if info['discount'] < 1:
      print('Lost all health.')
    if done and not self.finished:
      self.finished = True
      print('Episode done!')
      print(f'Duration: {self.steps}')
      print(f'Return: {self.episode_return:.1f}')
      if self.args.death == 'quit':
        self.running = False
      elif self.args.death == 'reset':
        print('\nStarting a new episode.')
        self._new_episode()
      # 'continue': keep stepping the dead world.

  def run(self):
    while self.running:
      self.draw()
      action = self.read_action()
      if action is None and self.args.wait:
        continue
      self.advance(action or 'noop')
    self.pygame.quit()


def main(argv=None):
  boolean = lambda x: bool(['False', 'True'].index(x))
  parser = argparse.ArgumentParser()
  parser.add_argument('--seed', type=int, default=None)
  parser.add_argument('--area', nargs=2, type=int, default=(64, 64))
  parser.add_argument('--view', type=int, nargs=2, default=(9, 9))
  parser.add_argument('--length', type=int, default=None)
  parser.add_argument('--health', type=int, default=9)
  parser.add_argument('--window', type=int, nargs=2, default=(600, 600))
  parser.add_argument('--size', type=int, nargs=2, default=(0, 0))
  parser.add_argument('--record', type=str, default=None)
  parser.add_argument('--fps', type=int, default=5)
  parser.add_argument('--wait', type=boolean, default=False)
  parser.add_argument('--death', type=str, default='reset',
                      choices=['continue', 'reset', 'quit'])
  parser.add_argument('--device', type=str, default='cuda')
  args = parser.parse_args(argv)

  try:
    import pygame
  except ImportError:
    print('Please install the pygame package to use the GUI.')
    raise

  import torch
  import crafter_tpu_torch
  from crafter_tpu_torch import rules

  if args.device.startswith('cuda') and not torch.cuda.is_available():
    raise SystemExit(
        'run_gui: no CUDA device found.  The engine runs on an NVIDIA GPU; '
        'pass --device cpu to run the plain PyTorch path on the CPU.')

  if args.health != 9:  # reference health override (run_gui.py:55-56)
    rules.override_rules(lambda r: r['items']['health'].update(
        max=args.health, initial=args.health))

  env = crafter_tpu_torch.Env(
      area=args.area, view=args.view, length=args.length or 10000,
      seed=args.seed, device=args.device)
  if args.record:
    env = crafter_tpu_torch.Recorder(env, args.record)
  env.reset()

  pygame.init()
  session = GuiSession(env, args, pygame)
  session.print_keymap()
  session.run()


if __name__ == '__main__':
  main()
