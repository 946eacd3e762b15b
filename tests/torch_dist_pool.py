"""A persistent pool of gloo ranks for the port's parallel tests.

`get_pool(world)` starts `world` spawned processes once per test module,
each a rank of one gloo process group (a `file://` store in a temporary
directory, so concurrent test workers never contend for a TCP port), with
one torch thread and `jax` / the JAX package blocked from import: the
ranks run the port alone. `pool.run(fn, *args)` runs `fn(rank, world,
*args, **kwargs)` on every rank (SPMD, as `torchrun` would) and returns the results
in rank order; `fn` lives in a module the ranks can import (it is sent by
name), its arguments and results are pickled (numpy arrays, not tensors).
A rank that raises fails the call with its traceback and the pool is
closed; the next `get_pool` starts a new one.
"""

from __future__ import annotations

import atexit
import datetime
import importlib
import multiprocessing as mp
import os
import queue
import shutil
import sys
import tempfile
import traceback

#: seconds a collective may wait before it raises in a rank
COLLECTIVE_TIMEOUT = 60
#: seconds a call may take before the pool is torn down
CALL_TIMEOUT = 300


def _worker(rank: int, world: int, store: str, tasks, results) -> None:
    sys.modules["jax"] = None  # the port never imports JAX
    sys.modules["llama3_quantization_tpu"] = None
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    while True:
        task = tasks.get()
        if task is None:
            break
        module, name, args, kwargs = task
        try:
            fn = getattr(importlib.import_module(module), name)
            results.put((rank, True, fn(rank, world, *args, **kwargs)))
        except BaseException:  # reported to the test, which fails with it
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int):
        ctx = mp.get_context("spawn")
        self.world = world
        self._tmp = tempfile.mkdtemp(prefix="rank_pool_")
        store = os.path.join(self._tmp, "store")
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_worker, args=(r, world, store, self._tasks[r], self._results),
                        daemon=True)
            for r in range(world)
        ]
        for p in self._procs:
            p.start()
        self.alive = True

    def run(self, fn, *args, timeout: float = CALL_TIMEOUT, **kwargs):
        """`fn(rank, world, *args, **kwargs)` on every rank; the results in
        rank order."""
        if not self.alive:
            raise RuntimeError("the rank pool is closed")
        for q in self._tasks:
            q.put((fn.__module__, fn.__name__, args, kwargs))
        got, errors = {}, []
        try:
            while len(got) + len(errors) < self.world:
                rank, ok, value = self._results.get(timeout=timeout)
                if ok:
                    got[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        except queue.Empty:
            self.close()
            raise TimeoutError(f"{fn.__name__}: {self.world - len(got)} ranks did not answer "
                               f"in {timeout} s") from None
        if errors:
            self.close()
            raise AssertionError(f"{fn.__name__} failed on {len(errors)} rank(s):\n"
                                 + "\n".join(errors))
        return [got[r] for r in range(self.world)]

    def close(self) -> None:
        if not self.alive:
            return
        self.alive = False
        for q in self._tasks:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        shutil.rmtree(self._tmp, ignore_errors=True)


_POOLS = {}


def get_pool(world: int) -> RankPool:
    """The running pool of `world` ranks of this process, started if none."""
    pool = _POOLS.get(world)
    if pool is None or not pool.alive:
        pool = _POOLS[world] = RankPool(world)
    return pool


class Ranks:
    """A test module's handle on the pool of `world` ranks: each `run` goes
    to the running pool, restarted after a failed call."""

    def __init__(self, world: int):
        self.world = world

    def run(self, fn, *args, **kwargs):
        return get_pool(self.world).run(fn, *args, **kwargs)

    def close(self) -> None:
        pool = _POOLS.pop(self.world, None)
        if pool is not None:
            pool.close()


def close_pools() -> None:
    for pool in _POOLS.values():
        pool.close()
    _POOLS.clear()


atexit.register(close_pools)
