"""``idle_in_stack_ms``: device idle ms a step while the main thread was in a
``tpugan.loop.stack`` range, in the span stretch (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    t = spans.of(run)
    return None if t is None else t.ms_per_step(t.split.under.get(spans.STACK, 0.0))
