"""``host_ms_per_step``: host ms a training step spent inside the port's
step or dispatch call (``make_step``, ``graph_steps``), from the
benchmark's span around ``call`` in the timed window."""


def read(run):
    steps = run.window_steps
    return 1e3 * sum(run.window.call_s) / steps if steps else None
