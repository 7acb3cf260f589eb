"""Start the ranks of a data-parallel run on one host.

``spawn(target, n, ...)`` runs ``target`` (``"module:function"``) in n
fresh Python processes (``torch.multiprocessing.start_processes``, the
``spawn`` start method), rank r of n, each with the environment torchrun
gives a rank (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``). With ``init`` the rank joins a process group over
a ``file://`` rendezvous in a fresh directory before it calls ``target``
(``dist.init_distributed``: rank r on ``cuda:r % device_count``, gloo
when ranks share a card or run on the CPU; the (data, spatial) layout
of ``spatial``) and leaves it after; without,
``target`` sets up the group itself (a CLI given the flags or torchrun's
environment), and ``UNI3DETR_RENDEZVOUS`` holds a rendezvous URL it may
use. Each rank's return value comes back through a pickle (return host
objects, not CUDA tensors); ``spawn`` returns them in rank order. When a
rank fails, the others are stopped and ``spawn`` raises with its
traceback; when the run outlasts ``timeout`` seconds, every rank is
killed and ``spawn`` raises. On the card the kernels are built once,
here, before the ranks start. The ``spawn`` start method imports the
caller's main script in every rank, so a script that calls ``spawn``
keeps its work under ``if __name__ == "__main__":``.
"""
from __future__ import annotations

import importlib
import os
import pickle
import shutil
import tempfile
import time
from typing import List, Optional


def spawn(target: str, n: int, args=(), kwargs=None, *, device="cuda",
          init: bool = True, timeout: float = 900.0,
          threads: Optional[int] = None, spatial: int = 1) -> List:
    """Run ``target(*args, **kwargs)`` on n ranks; returns their values.

    ``threads`` caps each rank's torch threads (``OMP_NUM_THREADS`` and
    ``torch.set_num_threads``). The ranks write to this process's
    standard output and error."""
    import torch.multiprocessing as mp

    if device == "cuda":
        from ..ops import cuda_lib
        cuda_lib.library()
    tmp = tempfile.mkdtemp(prefix="u3d_ranks_")
    add = dict(WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
               UNI3DETR_RENDEZVOUS="file://"
               + os.path.join(tmp, "rendezvous"))
    if threads:
        add["OMP_NUM_THREADS"] = str(threads)
    saved = {k: os.environ.get(k) for k in add}
    os.environ.update(add)          # the ranks inherit it when started
    try:
        ctx = mp.start_processes(
            _rank_entry, args=(tmp, target, tuple(args), dict(kwargs or {}),
                               device, init, threads, spatial),
            nprocs=n, join=False, start_method="spawn")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise RuntimeError(f"{target} on {n} ranks: timed out after "
                                   f"{timeout:.0f} s")
        results = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_entry(r, tmp, target, args, kwargs, device, init, threads,
                spatial):
    """Rank ``r``'s process: torchrun's environment, the group if
    ``init``, ``target``'s value pickled to ``tmp/rank{r}.pkl``."""
    os.environ.update(RANK=str(r), LOCAL_RANK=str(r))
    import torch
    if threads:
        torch.set_num_threads(threads)
    from . import dist
    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    if init:
        dist.init_distributed(os.environ["UNI3DETR_RENDEZVOUS"],
                              device=device, spatial=spatial)
    try:
        value = fn(*args, **kwargs)
    finally:
        if init:
            dist.destroy_distributed()
    path = os.path.join(tmp, f"rank{r}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(value, f)
    os.replace(path + ".tmp", path)
