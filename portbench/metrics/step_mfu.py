"""``step_mfu``: the whole step's share of the card's dense peak in the
cell's dtype, in %: the configuration's model FLOPs a step
(``counting.count_step``) times the steps a second of the timed window
(no profiler), over the peak (``peaks.py``)."""


def read(run):
    peak = run.peak_flops()
    w = run.window
    if peak is None or w.seconds <= 0:
        return None
    return 100.0 * run.cell.cfg["flops_per_step"] * run.window_steps / w.seconds / peak
