"""``kernels_per_step``: device kernels a training step in the profiled
stretch (a count; the trace taken by ``trace.steady_trace``'s rule)."""


def read(run):
    t = run.trace
    return len(t.kernels) / t.steps if t is not None and t.kernels else None
