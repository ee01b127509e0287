"""``lstm_step_us``: device microseconds a sequential LSTM cell step of
learn's forward scan: the mean device-clock interval of the ``lstm_scan``
spans in the window (``lstm_scan_ms``) over the cell steps of one scan,
the configuration's ``rollout_len``.  The latency that a fused cell or
scan kernel would cut."""

from benchmark import program_spans

install = program_spans.install


def read(ctx):
  ms = program_spans.device_ms(ctx, 'lstm_scan')
  if ms is None:
    return None
  return 1e3 * ms / ctx.cell.config['assumed']['rollout_len']
