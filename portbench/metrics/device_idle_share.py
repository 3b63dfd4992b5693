"""``device_idle_share``: the share of the profiled stretch in which no
kernel ran on the device, 1 - (union of the kernel intervals / the
stretch), in %."""


def read(run):
    t = run.trace
    if t is None or not t.kernels or t.window_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us() / t.window_us)
