"""Start the ranks of a process group on this host and collect what each
returns.

:func:`run_ranks` spawns one process per rank (the ``spawn`` start
method: a child imports only torch, this package and the module of its
target), joins them through a ``FileStore`` in a temporary directory (no
TCP port, so concurrent runs cannot collide), calls
``target(rank, device, *args)`` in each, and returns every rank's result
with its tensors as numpy arrays.  A rank that raises makes the run raise
(``torch.multiprocessing`` ends the other ranks); nothing is caught.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .scan import rank_device


def to_numpy(x: Any) -> Any:
    """``x`` with every tensor inside it (tuples, named tuples, lists,
    dicts) as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    return x


# a collective that waits longer than this fails the run
_TIMEOUT = datetime.timedelta(minutes=10)


def _rank_main(rank: int, world_size: int, backend: str, store_path: str,
               device, target: Callable, args: tuple, out_dir: str) -> None:
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world_size), rank=rank,
        world_size=world_size, timeout=_TIMEOUT)
    try:
        device = rank_device(device, None)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        result = to_numpy(target(rank, device, *args))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(target: Callable, world_size: int, backend: str = "gloo",
              device=None, *args) -> List[Any]:
    """Run ``target(rank, device, *args)`` on ``world_size`` spawned ranks
    of one process group over ``backend`` and return their results in rank
    order, tensors as numpy.

    ``target`` and ``args`` are pickled: ``target`` must be a module-level
    function of a module the children can import.  ``device`` is every
    rank's device (``"cpu"`` with gloo), or None for
    ``cuda:{rank % device_count}`` (``scan.rank_device``: a rank raises
    where there is no card).
    """
    with tempfile.TemporaryDirectory(prefix="bpt_ranks_") as tmp:
        mp.start_processes(
            _rank_main, args=(world_size, backend,
                              os.path.join(tmp, "store"), device, target,
                              args, tmp),
            nprocs=world_size, join=True, start_method="spawn")
        out = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
