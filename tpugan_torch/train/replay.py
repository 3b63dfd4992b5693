"""CycleGAN's 50-image replay buffer (``tpugan/train/replay.py``), kept on
the device.

Semantics of cyclegan/utils.py:13-33, applied to each batch element in
order: while the buffer is not full, store the element and return it; once
full, with probability 0.5 return a uniformly chosen stored element and put
the new one in its place, else return the new one. The coin and the index
come from an explicit generator on the host, or from arrays the caller
passes (so a test can feed both frameworks the same draws). The buffer makes
no draw while it fills.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from tpugan_torch.utils import tracing


class ReplayBuffer:
    def __init__(self, max_size: int, item_shape: Sequence[int], device, generator: torch.Generator):
        self.data = torch.zeros((max_size, *item_shape), dtype=torch.float32, device=device)
        self.count = 0
        self.generator = generator

    @property
    def max_size(self) -> int:
        return self.data.shape[0]

    def push_and_pop(
        self,
        batch: torch.Tensor,
        coins: Optional[Sequence[float]] = None,
        idxs: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        """Returns the batch the discriminator sees. ``coins`` (uniform in
        [0, 1), swap where > 0.5) and ``idxs`` give the draws for the
        elements that arrive with the buffer full, in order; drawn from the
        generator when omitted."""
        with tracing.span("tpugan.replay.push_and_pop"):
            batch = batch.detach().to(torch.float32)
            n_full = max(0, len(batch) - max(0, self.max_size - self.count))
            if coins is None:
                coins = torch.rand(n_full, generator=self.generator).tolist()
                idxs = torch.randint(0, self.max_size, (n_full,), generator=self.generator).tolist()
            out, draw = [], 0
            for element in batch:
                if self.count < self.max_size:
                    self.data[self.count] = element
                    self.count += 1
                    out.append(element)
                    continue
                coin, idx = coins[draw], int(idxs[draw])
                draw += 1
                if coin > 0.5:
                    out.append(self.data[idx].clone())
                    self.data[idx] = element
                else:
                    out.append(element)
            return torch.stack(out)
