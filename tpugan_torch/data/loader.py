"""Prefetching batch loaders (``tpugan/data/loader.py``).

Host batches are assembled on a background thread with the same index
streams as the JAX loaders (``default_rng(seed * 1000003 + epoch)``), so
the uint8 batches are byte-identical. Each batch is copied to the loader's
device: on CUDA from pinned host memory with ``non_blocking=True``. Batches
stay NHWC uint8; ``train.state.normalize_uint8`` converts them on the
device. The last partial batch is dropped, so every step has one shape.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch


class DeviceLoader:
    """Iterates batches of one or more aligned arrays (equal leading dim),
    as tuples of tensors on ``device``."""

    def __init__(
        self,
        arrays: Sequence[np.ndarray],
        batch_size: int,
        device,
        shuffle: bool = True,
        seed: int = 0,
        prefetch: int = 2,
        host_transform: Optional[Callable] = None,
    ):
        self.arrays = list(arrays)
        n = len(self.arrays[0])
        if any(len(a) != n for a in self.arrays):
            raise ValueError("arrays differ in length")
        self.n = n
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.host_transform = host_transform

    def __len__(self) -> int:
        return self.n // self.batch_size

    def _host_batches(self, epoch: int) -> Iterator[tuple]:
        from tpugan_torch import native

        rng = np.random.default_rng(self.seed * 1000003 + epoch)
        idx = rng.permutation(self.n) if self.shuffle else np.arange(self.n)
        for b in range(len(self)):
            sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
            batch = tuple(
                native.gather(a, sel) if a.dtype == np.uint8 else a[sel]
                for a in self.arrays
            )
            if self.host_transform is not None:
                batch = self.host_transform(batch, epoch, b)
            yield batch

    def _to_device(self, batch: tuple) -> tuple:
        out = []
        for a in batch:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            else:
                t = t.to(self.device)
            out.append(t)
        return tuple(out)

    def epoch(self, epoch: int) -> Iterator[tuple]:
        """Yield one epoch's device batches, ``prefetch`` ahead on a thread."""
        if self.prefetch <= 0:
            for batch in self._host_batches(epoch):
                yield self._to_device(batch)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            # An exception travels to the consumer and is raised there.
            try:
                for batch in self._host_batches(epoch):
                    if stop.is_set():
                        return
                    q.put(self._to_device(batch))
                q.put(None)
            except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():  # drain so the producer can finish
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()


class UnpairedLoader(DeviceLoader):
    """Unaligned two-domain loader (cyclegan/datasets.py:24-41): an epoch is
    max(len(A), len(B)) items, A cycled and shuffled, B drawn uniformly from
    all of B for every item."""

    def __init__(self, a: np.ndarray, b: np.ndarray, batch_size: int, device,
                 seed: int = 0, prefetch: int = 2, host_transform=None):
        super().__init__([a], batch_size, device, shuffle=True, seed=seed,
                         prefetch=prefetch, host_transform=host_transform)
        self.n = max(len(a), len(b))
        self._a = a
        self._b = b

    def _host_batches(self, epoch: int):
        from tpugan_torch import native

        rng = np.random.default_rng(self.seed * 1000003 + epoch)
        idx_a = rng.permutation(self.n) % len(self._a)
        for bi in range(len(self)):
            sel = idx_a[bi * self.batch_size : (bi + 1) * self.batch_size]
            b_sel = rng.integers(0, len(self._b), size=len(sel))
            batch = (native.gather(self._a, sel), native.gather(self._b, b_sel))
            if self.host_transform is not None:
                batch = self.host_transform(batch, epoch, bi)
            yield batch
