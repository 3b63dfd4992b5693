"""``input_wait_ms``: host ms a training step spent waiting in the port's
loader (``data/loader.py``: the hand-off from its thread), from the
benchmark's span around ``next_input`` in the timed window."""


def read(run):
    steps = run.window_steps
    return 1e3 * sum(run.window.input_s) / steps if steps else None
