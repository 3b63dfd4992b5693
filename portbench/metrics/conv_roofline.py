"""``conv_roofline``: the convolutions' share of their roofline, in %: the
configuration's convolution FLOPs a step (``counting.count_step``) times
the profiled steps, over the device time of the convolution kernels in the
profiled stretch, over the dtype's dense peak. Compute bounds a
convolution here. The convolution kernels are those that only convolution
ops launched in the run's first, eager step (``trace.conv_kernel_names``),
which names them in a replayed graph too."""


def read(run):
    t, peak = run.trace, run.peak_flops()
    if t is None or not run.conv_names or peak is None:
        return None
    conv_s = t.device_us(lambda name: name in run.conv_names) / 1e6
    if conv_s <= 0:
        return None
    return 100.0 * run.cell.cfg["conv_flops_per_step"] * t.steps / conv_s / peak
