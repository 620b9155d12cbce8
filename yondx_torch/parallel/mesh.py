"""Ranks over torch.distributed (port of yondx/parallel/mesh.py).

A `Mesh` is one rank's view of a 1-D group of processes: the group,
its rank and size, and its device. JAX's mesh is one program over many
chips; here every rank is its own process with its own card ("cuda:<local
rank>", NCCL) or, when the caller asks for the CPU, its own gloo rank. No
two ranks share a card: NCCL refuses it, and sharing would hide the
device a rank measures.

Ways to start the ranks:
- `spawn(n, fn, *args)`: n processes of torch.multiprocessing joined by a
  file store in a temporary directory; each runs fn(mesh, *args) and the
  caller gets every rank's return value;
- `torchrun --nproc-per-node N ...`: `make_mesh` joins the group its
  environment names (`init_multihost` does the same across hosts);
- one process with no group: `make_mesh(1)` makes a group of one.

`shard_batch` gives a rank its rows of a global batch; `replicate`
broadcasts rank 0's values.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the gloo groups made beside an NCCL default group, one per process
_SUBGROUPS = {}


@dataclasses.dataclass
class Mesh:
    """One rank's view of a 1-D mesh: its process group, its rank and the
    group's size, its device, the axis name, and the global ranks of the
    group's members (for point-to-point calls)."""
    group: Any
    rank: int
    size: int
    device: torch.device
    axis: str = "data"
    ranks: Sequence[int] = ()

    @property
    def shape(self):
        return {self.axis: self.size}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def peer(self, i: int) -> int:
        """The global rank of the group's member i."""
        return self.ranks[i]


def check_mesh(mesh) -> "Mesh":
    """`mesh` itself, or TypeError when it is not a port Mesh (a jax Mesh,
    a device count, ...)."""
    if not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a yondx_torch.parallel.Mesh (from "
                        f"make_mesh or spawn), got {type(mesh).__name__}")
    return mesh


def _device_type(device) -> str:
    return torch.device("cuda" if device is None else device).type


def check_cards(n: int, device=None) -> None:
    """ValueError when a mesh of n ranks on CUDA would need more cards
    than this machine has (one card a rank)."""
    if _device_type(device) != "cuda":
        return
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > have:
        raise ValueError(f"a mesh of {n} ranks on CUDA needs {n} cards, one "
                         f"a rank; this machine has {have}")


def _backend(dev_type: str) -> str:
    return "nccl" if dev_type == "cuda" else "gloo"


def _torchrun_env() -> bool:
    return all(k in os.environ for k in ("WORLD_SIZE", "RANK",
                                         "MASTER_ADDR", "MASTER_PORT"))


def make_mesh(n_devices: Optional[int] = None, device=None,
              axis: str = "data") -> Mesh:
    """This rank's Mesh over the running group of n_devices ranks.

    Joins the group torchrun's environment names, or uses the one already
    initialised (by `spawn`, or by the caller); with neither and
    n_devices in (None, 1) it makes a group of this process alone. device
    None or "cuda" puts the rank on cuda:<local rank> under NCCL; "cpu"
    on the CPU under gloo (beside an NCCL default group, a gloo group of
    the same ranks). Raises ValueError when the group's size is not
    n_devices or when CUDA has fewer cards than ranks."""
    dev_type = _device_type(device)
    if not dist.is_initialized():
        _SUBGROUPS.clear()
        if _torchrun_env():
            world = int(os.environ["WORLD_SIZE"])
            check_cards(n_devices or world, dev_type)
            if dev_type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(_backend(dev_type), init_method="env://")
        elif n_devices in (None, 1):
            check_cards(1, dev_type)
            dist.init_process_group(_backend(dev_type), store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:
            raise ValueError(
                f"a mesh of {n_devices} ranks needs {n_devices} processes: "
                "start them with yondx_torch.parallel.spawn or torchrun")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}) in a group of {size} ranks")
    check_cards(size, dev_type)
    group = dist.group.WORLD
    if dist.get_backend() != _backend(dev_type):
        key = _backend(dev_type)
        if key not in _SUBGROUPS:
            _SUBGROUPS[key] = dist.new_group(backend=key)
        group = _SUBGROUPS[key]
    if dev_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   dist.get_rank() % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    return Mesh(group=group, rank=dist.get_rank(group), size=size,
                device=dev, axis=axis, ranks=list(range(size)))


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a global batch (numpy array or tensor, rows on
    dim 0, a multiple of the mesh size), as a tensor on its device."""
    x = torch.as_tensor(batch)
    if x.shape[0] % mesh.size:
        raise ValueError(f"{x.shape[0]} rows do not split over "
                         f"{mesh.size} ranks")
    b = x.shape[0] // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b].to(mesh.device)


def replicate(mesh: Mesh, tree):
    """rank 0's values on every rank: tensors (moved to the rank's device),
    numpy arrays, the parameters and buffers of an nn.Module (in place),
    and dicts, lists and tuples of these; other leaves by pickling."""
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                dist.broadcast(t.data, mesh.peer(0), group=mesh.group)
        return tree
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to(mesh.device).contiguous().clone()
        dist.broadcast(t, mesh.peer(0), group=mesh.group)
        return t
    if isinstance(tree, np.ndarray):
        return replicate(mesh, torch.from_numpy(np.ascontiguousarray(
            tree))).cpu().numpy()
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    obj = [tree]
    dist.broadcast_object_list(obj, mesh.peer(0), group=mesh.group,
                               device=mesh.device
                               if mesh.device.type == "cuda" else None)
    return obj[0]


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> int:
    """Join a group across hosts: `coordinator` ("host:port"),
    `num_processes` and `process_id` when given, else torchrun's
    environment; NCCL when CUDA is present, gloo otherwise. Returns this
    process's rank (0 with no group to join)."""
    if not dist.is_initialized():
        backend = _backend("cuda" if torch.cuda.is_available() else "cpu")
        if coordinator is not None and num_processes is not None:
            dist.init_process_group(backend,
                                    init_method=f"tcp://{coordinator}",
                                    world_size=num_processes,
                                    rank=process_id)
        elif _torchrun_env():
            dist.init_process_group(backend, init_method="env://")
        else:
            return 0
    return dist.get_rank()


def run_calls(mesh: Mesh, calls) -> List[Any]:
    """[fn(mesh, *args, **kwargs) for (fn, args, kwargs) in calls], in
    order: one group serves several sharded calls."""
    return [fn(mesh, *args, **kwargs) for fn, args, kwargs in calls]


def _rank_entry(rank: int, n: int, dev_type: str, tmp: str, threads: int,
                fn: Callable, args, kwargs) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(threads)
    if dev_type == "cuda":
        torch.cuda.set_device(rank)
    store = dist.FileStore(os.path.join(tmp, "store"), n)
    dist.init_process_group(_backend(dev_type), store=store, rank=rank,
                            world_size=n)
    try:
        out = fn(make_mesh(n, device=dev_type), *args, **kwargs)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(n: int, fn: Callable, *args, device=None, **kwargs) -> List[Any]:
    """Run fn(mesh, *args, **kwargs) on n new processes, one rank each, on
    CUDA (one card a rank, NCCL) or, with device="cpu", on gloo; returns
    the ranks' return values in rank order. fn and its arguments must
    pickle (a module-level function). Each rank runs with the caller's
    torch thread count. Raises ValueError before starting anything when
    CUDA has fewer than n cards."""
    dev_type = _device_type(device)
    check_cards(n, dev_type)
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="yondx_torch_mesh_") as tmp:
        mp.spawn(_rank_entry, args=(n, dev_type, tmp, torch.get_num_threads(),
                                    fn, args, kwargs), nprocs=n, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(n)]
