"""``in_roofline``: the instance-norm kernels' share of their roofline, in
%: the bytes the IN sites of a step must move (``counting.in_bytes``:
forward x read and y written once, backward x and dy read and dx written
once, at the reference's shapes) times the profiled steps, over the device
time of the ``in_act_fwd*``/``in_act_bwd*`` kernels, over the card's
bandwidth. Bandwidth bounds them."""

from portbench import harness, peaks


def read(run):
    t, bw = run.trace, peaks.peak(run.kind, "bytes_per_s")
    if t is None or bw is None or not run.cell.cfg["in_elements_per_step"]["fwd"]:
        return None
    in_s = t.device_us(lambda name: harness.IN_KERNEL.search(name) is not None) / 1e6
    if in_s <= 0:
        return None
    return 100.0 * run.in_bytes_per_step() * t.steps / in_s / bw
