"""Process-group bring-up (port of gscodec_studio_tpu/parallel/launcher.py,
the reference's launcher, gsplat/distributed.py:304-360).

One process a card. Under ``torchrun --nproc_per_node=G script.py`` every
process finds RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT in
its environment; ``init_multihost`` joins them into one process group on
the backend its caller names ("nccl" by default; "gloo" when asked for),
and ``cli(fn)`` runs ``fn(rank, world_size, local_devices, ...)`` and
always destroys the group. ``spawn`` starts G local ranks itself, which
meet through a file store in a new temporary directory, for tests and
one-machine runs.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from gscodec_studio_tpu_torch.device import DeviceLike, resolve_device
from gscodec_studio_tpu_torch.parallel.distributed import Mesh, make_mesh

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_multihost(backend: str = "nccl", init_method: Optional[str] = None,
                   world_size: Optional[int] = None,
                   rank: Optional[int] = None) -> bool:
    """Joins the process group that torchrun's environment (or the
    arguments) describe, on ``backend``. Does nothing, and returns False,
    when a group exists already or when this is a single process with none
    of torchrun's variables set and no arguments."""
    if dist.is_initialized():
        return False
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if init_method is None and world_size is None and not any(
            k in os.environ for k in ENV):
        return False
    if backend == "nccl" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size if world_size else -1,
                            rank=rank if rank is not None else -1)
    return True


def local_devices(device: DeviceLike = None) -> List[torch.device]:
    """This process's device: cuda:LOCAL_RANK (the current card without
    torchrun) unless ``device`` names another."""
    if device is not None:
        return [resolve_device(device)]
    resolve_device(None)
    return [torch.device("cuda", int(os.environ.get(
        "LOCAL_RANK", torch.cuda.current_device())))]


def cli(fn: Callable, *args, backend: str = "nccl",
        device: DeviceLike = None, **kwargs):
    """Joins the group (init_multihost), runs ``fn(rank, world_size,
    local_devices, *args, **kwargs)`` and always destroys the group."""
    init_multihost(backend)
    try:
        rank = dist.get_rank() if dist.is_initialized() else 0
        world = dist.get_world_size() if dist.is_initialized() else 1
        return fn(rank, world, local_devices(device), *args, **kwargs)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def make_global_mesh(device: DeviceLike = None) -> Mesh:
    """The 1-D mesh over every rank of the world group (call after
    init_multihost): the Gaussians shard over all of them."""
    return make_mesh(device=local_devices(device)[0])


def _spawned(rank, world_size, backend, store, timeout, fn, args, queue):
    if backend == "gloo":
        # the ranks meet on this machine: gloo's transport on the loopback
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        backend, init_method=f"file://{store}", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout or 1800))
    try:
        # pickled to bytes here: torch's queue pickler would share tensors'
        # memory with a process that is about to exit
        queue.put(pickle.dumps((rank, fn(rank, world_size, *args))))
    finally:
        if dist.is_initialized():  # fn may have destroyed it (cli does)
            dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *args, backend: str = "gloo",
          timeout: Optional[float] = None):
    """Runs ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    joined into one group on ``backend`` (on this machine), and returns the ranks' results in rank order (each must pickle; tensors
    should be on the host). A failure in any rank raises here, and so do
    ``timeout`` seconds passing (the ranks are then terminated; it is also
    the group's collective timeout). ``fn`` must be importable by name (a
    module-level function)."""
    import torch.multiprocessing as mp

    queue = mp.get_context("spawn").SimpleQueue()
    tmp = tempfile.mkdtemp(prefix="gsc_spawn_")  # the group's file store
    try:
        procs = mp.start_processes(
            _spawned, args=(world_size, backend, os.path.join(tmp, "store"),
                            timeout, fn, args, queue),
            nprocs=world_size, join=False, start_method="spawn")
        t0 = time.monotonic()
        outs = {}
        done = False
        while not done:
            if timeout is not None and time.monotonic() - t0 > timeout:
                for p in procs.processes:
                    p.terminate()
                raise TimeoutError(f"spawn: the {world_size} ranks ran past "
                                   f"{timeout} s")
            # drain while the ranks run: a result larger than the pipe's
            # buffer blocks its rank until it is read
            while not queue.empty():
                rank, out = pickle.loads(queue.get())
                outs[rank] = out
            done = procs.join(timeout=0.05)  # raises if a rank failed
        while not queue.empty():
            rank, out = pickle.loads(queue.get())
            outs[rank] = out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return [outs[r] for r in range(world_size)]
