"""Host-side prefetching iterator.

The port's copy of the JAX package's `data/prefetch.py`: a thread pool in
place of the reference's DataLoader worker processes
(train_mp3d.py:404-413), so that chunk N+1 loads (h5py, JPEG decode and
numpy release the GIL) while the card runs chunk N. Workers do host work
only; the caller issues the host-to-device copies.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence


def prefetch_iterator(fetch: Callable[[int], object], indices: Sequence[int],
                      num_workers: int = 2, buffer: int = 4) -> Iterator:
    """Yield fetch(i) for i in indices, loading `buffer` items ahead with
    `num_workers` threads, in order. With no workers, fetch runs in the
    caller's thread when the item is asked for."""
    if num_workers <= 0:
        for i in indices:
            yield fetch(i)
        return
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        it = iter(indices)
        pending = [pool.submit(fetch, i) for _, i in zip(range(buffer), it)]
        while pending:
            fut = pending.pop(0)
            for i in it:
                pending.append(pool.submit(fetch, i))
                break
            yield fut.result()
