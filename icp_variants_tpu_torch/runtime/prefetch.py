"""Background batch prefetcher: the next batch loads while this one runs.

Port of ``icp_variants_tpu.runtime.prefetch``. The reference loads each
ETH pair inside its sweep loop (main.cpp:411-439, through PCL); here the
next batch's parse, normals, kd builds and perturbation run on a worker
thread while the current batch's ICP run is queued on the card. The parse
runs in the native thread pool and the kd partition in native code, both
without the interpreter lock.

With ``device`` a CUDA device, the worker issues its device work (the
normals) on a stream of its own, so it runs on the card beside the
current batch's run instead of queueing behind it on the consumer's
stream. Each result is handed over with an event recorded on that stream
after its work: :meth:`Prefetcher.__next__` makes the consumer's current
stream wait on it, and marks every CUDA tensor of the result as used by
that stream, so the allocator does not hand its memory back to the worker
while the consumer's kernels may still read it.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

import torch

T = TypeVar("T")

_SENTINEL = object()


def _cuda_tensors(value):
    """Every CUDA tensor inside ``value`` (tuples, lists, dicts, NamedTuples
    and dataclass-like objects with ``__dict__``)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _cuda_tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _cuda_tensors(v)
    elif hasattr(value, "__dict__"):
        for v in vars(value).values():
            yield from _cuda_tensors(v)


class Prefetcher(Iterator[T]):
    """Iterate ``fn(item)`` for each work item, computing ``depth`` results
    ahead on a daemon worker thread.

    Exceptions raised by ``fn`` re-raise at the corresponding ``__next__``
    (fault containment stays with the consumer). ``device``: where ``fn``
    launches device work (``None`` or a CPU device: no stream handling).
    """

    def __init__(self, items: Iterable, fn: Callable[..., T], depth: int = 1, device=None):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._items = list(items)
        self._fn = fn
        dev = None if device is None else torch.device(device)
        self._stream = (torch.cuda.Stream(dev) if dev is not None and dev.type == "cuda"
                        else None)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _run(self, item):
        if self._stream is None:
            return self._fn(item), None
        with torch.cuda.stream(self._stream):
            value = self._fn(item)
            done = torch.cuda.Event()
            done.record(self._stream)
        return value, done

    def _worker(self):
        try:
            for it in self._items:
                try:
                    value, done = self._run(it)
                    self._q.put((value, done, None))
                except Exception as e:  # noqa: BLE001 — re-raised in the consumer
                    self._q.put((None, None, e))
        finally:
            self._q.put(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self) -> T:
        got = self._q.get()
        if got is _SENTINEL:
            # Re-queue the sentinel: a second next() after exhaustion must
            # raise StopIteration again, not block on an empty queue.
            self._q.put(_SENTINEL)
            raise StopIteration
        value, done, err = got
        if err is not None:
            raise err
        if done is not None:
            consumer = torch.cuda.current_stream(self._stream.device)
            consumer.wait_event(done)
            for t in _cuda_tensors(value):
                t.record_stream(consumer)
        return value
