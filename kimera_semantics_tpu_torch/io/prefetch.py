"""Background frame prefetch for the streaming server.

Counterpart: kimera_semantics_tpu/io/prefetch.py. A bounded producer
thread decodes frames ahead of the integrator (the ROS subscriber queue of
the reference). Where the producer puts work on a CUDA card (a frame
rendered there), `device` orders it with the consumer: the producer
records an event after each item on its current stream, and the consumer's
current stream waits on that event before the item is used.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

import torch

from ..utils import timing

T = TypeVar("T")

_SENTINEL = object()


def prefetch(iterable: Iterable[T], depth: int = 2,
             device=None) -> Iterator[T]:
    """Yield items of `iterable`, produced by a background thread through a
    bounded queue. Order-preserving; producer exceptions re-raise at the
    consumption point. depth <= 0 yields the iterable unchanged. `device`:
    the CUDA device the producer may enqueue work on (None: none)."""
    if depth <= 0:
        yield from iterable
        return
    cuda = device is not None and torch.device(device).type == "cuda"
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list = []

    def worker():
        try:
            for item in iterable:
                ev = None
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(device))
                q.put((item, ev))
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True, name="ksd-prefetch")
    t.start()
    while True:
        with timing.span("server/prefetch_wait"):
            item = q.get()
        if item is _SENTINEL:
            t.join()
            if err:
                raise err[0]
            return
        item, ev = item
        if ev is not None:
            torch.cuda.current_stream(device).wait_event(ev)
        yield item
