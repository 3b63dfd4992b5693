"""CLI: ``python -m tpugan_torch <model> [flags]``, with the flags of
``python -m tpugan <model>``."""

from __future__ import annotations

import sys

from tpugan_torch.models import registry


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "list"):
        print("usage: python -m tpugan_torch <model> [flags]")
        print("ported models:")
        for name in registry.names():
            print("  " + name)
        return 0
    registry.get(argv[0]).main(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
