"""``idle_in_eager_ms``: device idle ms a step while the main thread was in a
``tpugan.step`` range outside any ``tpugan.graph.*`` range (the eager
steps of each epoch's tail), in the span stretch (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    t = spans.of(run)
    return None if t is None else t.ms_per_step(t.split.eager)
