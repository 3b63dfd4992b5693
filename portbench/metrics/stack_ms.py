"""``stack_ms``: host ms a step the main thread spent in the port's
``tpugan.loop.stack`` ranges (``train/loop.py:_stack_batches``, a
dispatch's batches stacked along K) in the span stretch
(``portbench/spans.py``)."""

from portbench import spans


def read(run):
    t = spans.of(run)
    return None if t is None else t.ms_per_step(t.span_us(spans.STACK))
