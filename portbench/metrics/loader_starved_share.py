"""``loader_starved_share``: the share of the loader's hand-offs in the span
stretch (``portbench/spans.py``) for which the consumer found the
producer's queue empty, ``input.starved`` over ``input.handoffs`` of
``tpugan_torch.utils.tracing.counts``, in %."""

from portbench import spans


def read(run):
    t = spans.of(run)
    handoffs = t.counts.get("input.handoffs", 0) if t is not None else 0
    return 100.0 * t.counts.get("input.starved", 0) / handoffs if handoffs else None
