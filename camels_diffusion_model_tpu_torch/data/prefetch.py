"""Stage host batches on the card ahead of the step that uses them
(counterpart of ``camels_diffusion_model_tpu/data/prefetch.py``).

The JAX package copies on a worker thread because ``device_put`` blocks its
caller.  Here the copies are asynchronous already: each batch's arrays are
pinned and copied ``non_blocking`` on a side stream, ``depth`` batches ahead,
and the consumer's stream waits on the copy's event before it uses them.  So
no thread is needed, and the copy of batch ``n + depth`` overlaps the step of
batch ``n``.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch


def device_prefetch(iterable: Iterable, device, transform: Optional[Callable] = None,
                    depth: int = 2) -> Iterator[tuple]:
    """Yield each item of ``iterable`` as a tuple of tensors on ``device``.

    ``transform`` maps an item to a tuple of host arrays first (the
    experiment runner's wrap-padding and mask); without it the item must be
    one.  Order and count are kept exactly.  An exception of the source or
    of ``transform`` reaches the consumer in its place: the items staged
    before it are yielded first.  On the CPU the arrays are only wrapped.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    device = torch.device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    it = iter(iterable)

    def stage():
        """The next item staged: (tensors, copy event), or None at the end;
        an exception is returned, to be raised in its turn."""
        try:
            item = next(it)
            arrays = transform(item) if transform is not None else item
            host = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
        except StopIteration:
            return None
        except Exception as e:  # raised at the consumer, after the earlier items
            return e
        if not cuda:
            return host, None
        host = tuple(t.pin_memory() for t in host)
        with torch.cuda.stream(stream):
            staged = tuple(t.to(device, non_blocking=True) for t in host)
            event = torch.cuda.Event()
            event.record(stream)
        return staged, event

    queue = collections.deque()
    for _ in range(depth):
        queue.append(stage())
        if not isinstance(queue[-1], tuple):
            break
    while queue:
        entry = queue.popleft()
        if entry is None:
            return
        if isinstance(entry, Exception):
            raise entry
        tensors, event = entry
        if event is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)
            for t in tensors:  # the side stream's memory is used on this one
                t.record_stream(consumer)
        if not queue or isinstance(queue[-1], tuple):
            queue.append(stage())
        yield tensors
