"""Benchmark timing protocol: the port's copy of ``tpugan/utils/benchtime.py``.

- ``dispatch(n)`` runs n dispatches of device work and ends with
  ``torch.cuda.synchronize()`` inside its clock, so the time covers the
  device's work and not only the host's enqueue.
- Warm-up is one dispatch (cuDNN's algorithm choice, allocator growth, the
  first burst).
- Difference method over two run lengths: rate = extra work / (t2 - t1),
  with each length timed 3 times and the minimum taken (interference only
  ever adds time); differencing the minima removes the fixed cost of a
  burst. The pair is valid only when the long run took meaningfully longer
  (t2 - t1 > 0.2 * t2); otherwise the direct rate n2 * work / t2 is the
  conservative answer.
"""

from __future__ import annotations

from typing import Callable


def measure_images_per_sec(
    dispatch: Callable[[int], float],
    images_per_dispatch: float,
    n1: int,
    n2: int,
) -> float:
    """Difference-method throughput. ``dispatch(n)`` runs n synchronised
    dispatches and returns the elapsed wall-clock seconds."""
    dispatch(1)  # warm-up
    t1 = min(dispatch(n1) for _ in range(3))
    t2 = min(dispatch(n2) for _ in range(3))
    if t2 - t1 > 0.2 * t2:
        return (n2 - n1) * images_per_dispatch / (t2 - t1)
    return n2 * images_per_dispatch / t2
