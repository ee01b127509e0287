"""``lstm_scan_ms``: the mean device-clock interval of the program's
``lstm_scan`` span (the recurrent policy's forward scan of one learn
minibatch: 64 LSTM cell steps over 512 envs) in the window, between the
CUDA events the span records with no synchronise."""

from benchmark import program_spans

install = program_spans.install


def read(ctx):
  return program_spans.device_ms(ctx, 'lstm_scan')
