"""Host-side loading helpers (after ``uni3detr_tpu/data/loading.py``)."""
from __future__ import annotations

import queue
import threading


def prefetch(iterator, depth: int = 2):
    """Run an iterator in a background thread with a bounded queue so
    that host-side loading and collation overlap the device's work (the
    role of the reference's DataLoader workers). Errors raised by the
    iterator reach the consumer. A consumer that stops early (``break``,
    ``return``, an exception) lets the thread end after the item it is
    producing, where the JAX package's thread waits on the full queue for
    good."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    END = object()
    err: list = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
        except BaseException as e:  # surface loader errors to the consumer
            err.append(e)
        finally:
            put(END)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
