"""Process bootstrap and small collectives (port of
mugiq_tpu.parallel.distributed).

The reference starts its ranks with mpirun and initComms(--gridsize)
(the reference's tests/eigensolve.cpp:683).  Here every rank is one
process of a torch.distributed process group:

* launched by ``python -m torch.distributed.run --nproc-per-node N ...``,
  whose environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR) is read
  when no coordinator is given (the analog of the JAX package's pod
  launcher auto-detection);
* or started by hand with ``--dist-coordinator host:port
  --dist-num-processes N --dist-process-id I`` on every process.

The backend is explicit (``--dist-backend``): NCCL when every rank has a
card of its own, gloo on the CPU and when ranks share a card (the halos
are then staged through pinned host buffers, :mod:`.halo`).  NCCL cannot
form a communicator with two ranks on one card, so that request raises;
nothing switches backend by itself.  A rank's device is
``cuda:{LOCAL_RANK % device_count}``.
"""

import os
from typing import Optional

import numpy as np
import torch


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None else int(v)


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, device_type: str, local_ranks: int,
                  cards: int) -> None:
    """Raise for a backend that cannot serve `local_ranks` ranks of this
    host on `cards` cards."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"--dist-backend must be nccl or gloo: {backend!r}")
    if backend != "nccl":
        return
    if device_type != "cuda":
        raise ValueError("the NCCL backend needs CUDA devices; CPU ranks "
                         "run on --dist-backend gloo")
    if local_ranks > cards:
        raise ValueError(
            f"NCCL cannot form a communicator with several ranks on one "
            f"card: {local_ranks} ranks of this host share {cards} card(s). "
            f"Give every rank a card of its own, or use --dist-backend gloo "
            f"(halos staged through host memory)")


def rank_device(device, local_rank: int) -> torch.device:
    """The device of a rank: ``cuda`` becomes cuda:{local_rank % cards};
    an explicit index or the CPU stays as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda") -> torch.device:
    """Start the process group (reference: initComms / MPI_Init) and return
    this rank's device.

    coordinator "host:port" with num_processes and process_id starts it by
    hand; without a coordinator the environment of torch.distributed.run
    is used; with neither, the process runs alone without a group.
    backend defaults to nccl for CUDA devices and gloo for the CPU.
    A second call returns the device and starts nothing."""
    import torch.distributed as dist

    from ..utils import resolve_device

    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--dist-coordinator needs --dist-num-processes "
                             "and --dist-process-id")
        init_method, world, rank = (f"tcp://{coordinator}", num_processes,
                                    process_id)
    elif _env_int("RANK") is not None and _env_int("WORLD_SIZE") is not None:
        init_method, world, rank = ("env://", _env_int("WORLD_SIZE"),
                                    _env_int("RANK"))
    else:
        check_backend(backend, dev.type, 1, cards)
        return dev
    local = _env_int("LOCAL_RANK")
    local = rank if local is None else local
    local_ranks = _env_int("LOCAL_WORLD_SIZE") or world
    check_backend(backend, dev.type, local_ranks, cards)
    rdev = rank_device(dev, local)
    if dist.is_initialized():
        return rdev
    if rdev.type == "cuda":
        torch.cuda.set_device(rdev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return rdev


def gather_global(obj) -> list:
    """Every rank's `obj` (small picklable data), on every rank: the
    reference's MPI_Gather + Bcast epilogue for tiny results."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def save_evecs_sharded(path_prefix: str, evecs, evals=None,
                       mesh=None) -> str:
    """Per-rank evec checkpoint: this rank writes its block of the global
    kernel-layout batch [n, T, 24, Z, Y*X] (or [n, T, 24, Z, Y*X/2]
    packed) to ``<prefix>.proc<rank>.npz`` with the JAX package's keys:
    global_shape, shard0 (the block), index0 ((start, stop) of the block
    on every axis of the global array) and evals (the scale-out
    alternative to gathering to the primary; reference analog: per-rank
    QIO volumes).  mesh: the run's LatticeMesh (None: one rank holding
    the whole batch).  Returns the path written."""
    block = np.asarray(evecs.cpu().numpy() if isinstance(evecs, torch.Tensor)
                       else evecs)
    rank = 0 if mesh is None else mesh.rank
    gshape = (tuple(block.shape) if mesh is None
              else _global_batch_shape(block.shape, mesh))
    index = _batch_index(gshape, mesh)
    extra = {} if evals is None else {"evals": np.asarray(evals)}
    path = f"{path_prefix}.proc{rank}.npz"
    np.savez(path, global_shape=np.asarray(gshape, dtype=np.int64),
             shard0=block, index0=np.asarray(index, dtype=np.int64), **extra)
    return path


def load_evecs_sharded(path_prefix: str, mesh=None, device="cuda"):
    """(this rank's block as a torch tensor on `device`, evals or None)
    from save_evecs_sharded's file of this rank (or the JAX package's
    file of a single-device array).  The mesh must have the saving run's
    shape: a block that is not this rank's raises."""
    rank = 0 if mesh is None else mesh.rank
    with np.load(f"{path_prefix}.proc{rank}.npz") as z:
        gshape = tuple(int(d) for d in z["global_shape"])
        # a stop of -1 is the JAX writer's whole axis
        index = [[a, d if b < 0 else b]
                 for (a, b), d in zip(z["index0"].tolist(), gshape)]
        block = z["shard0"]
        evals = z["evals"] if "evals" in z.files else None
    want = _batch_index(gshape, mesh)
    if index != want:
        raise ValueError(
            f"{path_prefix}.proc{rank}.npz holds the block {index} of "
            f"{list(gshape)}, but rank {rank} of this mesh holds {want}: "
            f"load on a mesh of the saving run's shape")
    return torch.from_numpy(block).to(device), evals


def _global_batch_shape(block_shape, mesh):
    """The global batch shape of a rank's block [n, Tl, 24, Zl, Yl*W]."""
    s = list(block_shape)
    s[1] *= mesh.shape["t"]
    s[-2] *= mesh.shape["z"]
    s[-1] *= mesh.shape["y"]
    return tuple(s)


def _batch_index(gshape, mesh):
    """[[start, stop], ...] of this rank's block on every axis of a global
    batch (t on axis 1)."""
    if mesh is None:
        return [[0, int(d)] for d in gshape]
    idx = mesh._block(gshape, 1, mesh.rank)
    return [[0 if sl.start is None else sl.start,
             d if sl.stop is None else sl.stop]
            for sl, d in zip(idx, gshape)]


def shutdown_distributed() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
