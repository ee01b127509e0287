"""An autouse fixture that pins PyTorch to one thread for a test module.

The suite runs several workers side by side; PyTorch's thread pool, sized
for the whole machine in each of them, then spends its time spinning.  The
port's CPU tests are small: one thread is enough.  A test module takes the
fixture by importing it: ``from one_thread import one_torch_thread``.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
  before = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(before)
