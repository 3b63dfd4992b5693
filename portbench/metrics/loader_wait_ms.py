"""``loader_wait_ms``: host ms a step the main thread spent in the port's
``tpugan.input.wait`` ranges (``DeviceLoader.epoch``, from asking for a
batch to holding it) in the span stretch (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    t = spans.of(run)
    return None if t is None else t.ms_per_step(t.span_us(spans.INPUT_WAIT))
