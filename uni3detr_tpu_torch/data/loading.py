"""Host-side loading helpers (copy of ``uni3detr_tpu/data/loading.py``)."""
from __future__ import annotations

import queue
import threading


def prefetch(iterator, depth: int = 2):
    """Run an iterator in a background thread with a bounded queue so
    that host-side loading and collation overlap the device's work (the
    role of the reference's DataLoader workers). Errors raised by the
    iterator reach the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    END = object()
    err: list = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # surface loader errors to the consumer
            err.append(e)
        finally:
            q.put(END)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is END:
            if err:
                raise err[0]
            return
        yield item
