import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


@pytest.fixture(scope='session')
def tiny_root(tmp_path_factory):
  import tiny
  return tiny.make_root(tmp_path_factory.mktemp('tiny'))


@pytest.fixture
def card():
  """Skips a test that needs an NVIDIA GPU where there is none."""
  import torch
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
