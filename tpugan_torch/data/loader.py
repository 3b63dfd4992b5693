"""Prefetching batch loaders (``tpugan/data/loader.py``).

Host batches are assembled on a background thread with the same index
streams as the JAX loaders (``default_rng(seed * 1000003 + epoch)``), so
the uint8 batches are byte-identical. Each batch is copied to the loader's
device: on CUDA from pinned host memory with ``non_blocking=True``. Batches
stay NHWC uint8; ``train.state.normalize_uint8`` converts them on the
device. The last partial batch is dropped, so every step has one shape.

Under data parallelism (``dp``, ``tpugan_torch/parallel/mesh.py``) every
rank draws the same permutation from the seed, assembles the same global
batch and keeps its contiguous share of the rows; ``len`` counts global
batches. A ragged tail cannot divide over the ranks, so there
``--ragged_last_batch`` drops it with the JAX package's warning
(``tpugan/data/loader.py:78-84``).
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from tpugan_torch.parallel.mesh import DataParallel
from tpugan_torch.utils import tracing

# --debug_numerics: every loader runs on the calling thread, without its
# producer thread and queue, the input pipeline's only concurrency.
_SYNCHRONOUS = False

# Whether a loader built from now on drops the n % batch_size tail
# (--ragged_last_batch sets it False).
_DROP_LAST = True


def set_synchronous(on: bool) -> None:
    global _SYNCHRONOUS
    _SYNCHRONOUS = bool(on)


def set_drop_last(on: bool) -> None:
    global _DROP_LAST
    _DROP_LAST = bool(on)


class DeviceLoader:
    """Iterates batches of one or more aligned arrays (equal leading dim),
    as tuples of tensors on ``device``. The tail of n % batch_size is
    dropped unless ``set_drop_last(False)`` came before the loader was
    built and there is no ``dp``. With ``dp`` each batch is this rank's
    share of the global batch of ``batch_size``."""

    def __init__(
        self,
        arrays: Sequence[np.ndarray],
        batch_size: int,
        device,
        shuffle: bool = True,
        seed: int = 0,
        prefetch: int = 2,
        host_transform: Optional[Callable] = None,
        dp: Optional[DataParallel] = None,
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
        self.dp = dp
        self.drop_last = _DROP_LAST
        if not self.drop_last and dp is not None and self._items() % batch_size != 0:
            warnings.warn(
                "[tpugan] --ragged_last_batch is incompatible with a "
                "sharded (data-parallel) batch; dropping the tail batch",
                stacklevel=2,
            )
            self.drop_last = True

    def _items(self) -> int:
        """Items an epoch."""
        return self.n

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

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

    def _rank_batches(self, epoch: int) -> Iterator[tuple]:
        """The host batches of ``epoch``, each cut to this rank's rows (after
        the host transform, whose draws are the global batch's)."""
        if self.dp is None:
            yield from self._host_batches(epoch)
            return
        for batch in self._host_batches(epoch):
            share = len(batch[0]) // self.dp.world
            lo = self.dp.rank * share
            yield tuple(a[lo:lo + share] for a in batch)

    def _to_device(self, batch: tuple) -> tuple:
        out = []
        with tracing.span("tpugan.input.to_device"):
            for a in batch:
                t = torch.from_numpy(np.ascontiguousarray(a))
                if self.device.type == "cuda":
                    t = t.pin_memory().to(self.device, non_blocking=True)
                else:
                    t = t.to(self.device)
                out.append(t)
        return tuple(out)

    def epoch(self, epoch: int) -> Iterator[tuple]:
        """Yield one epoch's device batches, ``prefetch`` ahead on a thread
        (on the calling thread under ``set_synchronous(True)``). The
        consumer's wait for each batch is the span ``tpugan.input.wait``; on
        the thread's path each batch handed over counts ``input.handoffs``,
        and ``input.starved`` where the queue was empty when it was asked
        for (``utils/tracing.py``)."""
        if _SYNCHRONOUS or self.prefetch <= 0:
            batches = self._rank_batches(epoch)
            while True:
                with tracing.span("tpugan.input.wait"):
                    batch = next(batches, None)
                    if batch is not None:
                        batch = self._to_device(batch)
                if batch is None:
                    return
                yield batch

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            # An exception travels to the consumer and is raised there.
            try:
                for batch in self._rank_batches(epoch):
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
                with tracing.span("tpugan.input.wait"):
                    try:
                        item, starved = q.get_nowait(), False
                    except queue.Empty:
                        item, starved = q.get(), True
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                tracing.count("input.handoffs")
                if starved:
                    tracing.count("input.starved")
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
                 seed: int = 0, prefetch: int = 2, host_transform=None,
                 dp: Optional[DataParallel] = None):
        self._a = a
        self._b = b
        super().__init__([a], batch_size, device, shuffle=True, seed=seed, prefetch=prefetch,
                         host_transform=host_transform, dp=dp)
        self.n = self._items()

    def _items(self) -> int:
        return max(len(self._a), len(self._b))

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


class ZipLoader:
    """Independently shuffled loaders zipped (``tpugan/data/loader.py:204-235``;
    ``zip(dataloader1, dataloader2)`` in cogan/cogan.py:184 and
    pixelda/pixelda.py:221): each batch is the concatenation of the members'
    batch tuples, and an epoch is as long as the shortest member. Every
    member's prefetch thread is closed when the epoch ends, early or on an
    error."""

    def __init__(self, *loaders: DeviceLoader):
        self.loaders = loaders

    def __len__(self) -> int:
        return min(len(l) for l in self.loaders)

    def epoch(self, epoch: int) -> Iterator[tuple]:
        its = [l.epoch(epoch) for l in self.loaders]
        try:
            for _ in range(len(self)):
                yield tuple(t for it in its for t in next(it))
        finally:
            for it in its:
                it.close()
