"""CLI: ``python -m tpugan_torch <model> [flags]``, with the flags of
``python -m tpugan <model>``; data-parallel over N cards with
``torchrun --nproc_per_node N -m tpugan_torch <model> [flags]``."""

from __future__ import annotations

import sys

import torch

from tpugan_torch.models import registry
from tpugan_torch.parallel.mesh import in_data_parallel


def one_device_notice(argv) -> str:
    """The line a process without a launcher prints when it sees several
    CUDA devices: the JAX package would spread the batch over them, a torch
    process trains on one."""
    n = torch.cuda.device_count()
    if n <= 1 or in_data_parallel():
        return ""
    return ("[tpugan] %d CUDA devices visible, training on ONE: a torch process sees only "
            "its own rank. For data parallelism over all of them run: torchrun "
            "--nproc_per_node %d -m tpugan_torch %s" % (n, n, " ".join(argv)))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "list"):
        print("usage: python -m tpugan_torch <model> [flags]")
        print("ported models:")
        for name in registry.names():
            print("  " + name)
        return 0
    notice = one_device_notice(argv)
    if notice:
        print(notice)
    registry.get(argv[0]).main(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
