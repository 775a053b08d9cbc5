"""Process groups and the SPMD harness, over torch.distributed.

Counterpart of `arrowtpu/parallel/mesh.py`.  Where the JAX package stacks
per-device batches and runs one program over a device mesh (`shard_map`),
here each rank is a process holding its own RecordBatch shard, and the
exchange operator (parallel/shuffle.py) is a torch.distributed
`all_to_all_single` instead of an XLA collective.

  * `Group`: a rank's handle (rank, world size, device).  CPU tensors use
    the gloo backend, the card NCCL, one rank per card (rank r on cuda:r).
  * `process_group`: joins the default process group for the duration of
    a `with` block.  Several ranks meet at a TCP store on localhost, which
    `run` hosts on a port the OS picks as it binds it (no port is chosen
    first and bound later, so no other process can take it in between);
    one rank needs no port (an in-process store).
  * `run(fn, world_size, device, *args)`: fn(group, *args) on every rank;
    -> the per-rank results, in rank order.  One rank runs in the calling
    process; more are spawned (fresh interpreters, so fn and args go by
    pickle and fn must be a module-level function of an importable
    module), and every process started is stopped before `run` returns.
    Spawned CPU ranks split the caller's torch threads between them.
  * `normalize_batch`: every column gets a validity bitmap, so every rank
    exchanges the same planes whatever its data (the JAX package needs it
    to stack shards; here it keeps the collectives of all ranks in step).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import multiprocessing as mp
import pickle
import queue
import time
import traceback
from typing import Callable, List

import torch
import torch.distributed as dist

from ..config import resolve_device
from ..core import batch as bt
from ..core import bitmap as bm
from ..core import column as col


RANK_TIMEOUT_S = 600  # a spawned rank's time to join, run and answer


@dataclasses.dataclass(frozen=True)
class Group:
    rank: int
    world_size: int
    device: torch.device


def _rank_device(device: torch.device, rank: int) -> torch.device:
    if device.type == "cuda":
        return torch.device("cuda", rank)
    return device


@contextlib.contextmanager
def process_group(rank: int, world_size: int, device, port: int = None):
    """Join the default process group as `rank` of `world_size`; yields
    the rank's Group and leaves the group on exit.  `port` is that of the
    TCP store the ranks meet at (`run` hosts one); a group of one rank
    takes none."""
    device = _rank_device(torch.device(device), rank)
    if port is None:
        if world_size != 1:
            raise ValueError(f"{world_size} ranks meet at a TCP store: give "
                             "its port")
        store = dist.HashStore()
    else:
        store = dist.TCPStore("localhost", port, is_master=False,
                              timeout=datetime.timedelta(
                                  seconds=RANK_TIMEOUT_S))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=store, world_size=world_size, rank=rank)
    try:
        yield Group(rank, world_size, device)
    finally:
        dist.destroy_process_group()


def _rank_main(rank, world_size, device, port, threads, fn, args, results):
    """A spawned rank: join the group, run fn, send back its pickled result
    or the traceback.  `threads`: torch's CPU threads for the rank, or None
    to keep torch's default."""
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        with process_group(rank, world_size, device, port) as group:
            out = fn(group, *args)
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run(fn: Callable, world_size: int, device=None, *args) -> List:
    """fn(group, *args) on `world_size` ranks; -> results in rank order.
    Raises if a rank fails or does not answer within RANK_TIMEOUT_S."""
    device = resolve_device(device)
    if device.type == "cuda" and world_size > torch.cuda.device_count():
        raise RuntimeError(f"{world_size} ranks need {world_size} CUDA "
                           f"devices; {torch.cuda.device_count()} found")
    if world_size == 1:
        with process_group(0, 1, device) as group:
            return [fn(group, *args)]
    # the ranks' store, on a port the OS picks as the store binds it
    store = dist.TCPStore("localhost", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    # CPU ranks share the caller's threads instead of each taking them all
    threads = (max(1, torch.get_num_threads() // world_size)
               if device.type == "cpu" else None)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, str(device), store.port,
                               threads, fn, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while len(out) < world_size:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                lost = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if lost:
                    raise RuntimeError(f"ranks {lost} exited without a "
                                       "result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"no result from every rank within "
                                       f"{RANK_TIMEOUT_S} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            out[rank] = pickle.loads(payload)
    finally:
        for p in procs:
            p.join(timeout=30 if len(out) == world_size else 0)
            if p.is_alive():
                p.terminate()
                p.join()
    return [out[r] for r in range(world_size)]


def _with_validity(c: col.Column) -> col.Column:
    if c.validity is not None or isinstance(c, col.NullColumn):
        return c
    if isinstance(c, col.DictionaryColumn):  # the validity of its keys
        return dataclasses.replace(c, keys=_with_validity(c.keys))
    return dataclasses.replace(
        c, validity=bm.row_mask(c.capacity, c.length, c.device))


def normalize_batch(batch: bt.RecordBatch) -> bt.RecordBatch:
    return bt.RecordBatch(batch.schema,
                          tuple(_with_validity(c) for c in batch.columns))
