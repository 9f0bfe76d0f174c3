"""The rank grid over the (t, z[, y]) lattice axes (port of
mugiq_tpu.parallel.mesh.make_lattice_mesh).

The reference runs one MPI rank per block of its --gridsize process grid
(the reference's tests/eigensolve.cpp:683).  Here one torch.distributed
process holds one block of the global lattice.  The mesh has 2 or 3
extents over (t, z[, y]), as the JAX package's; x is never partitioned.
Rank order is that of the JAX device array reshaped row-major to the mesh
shape: rank = (it*nz + iz)*ny + iy.

Every kernel-layout array carries t on one axis (``lead``: 0 for a field,
1 for a batch), z on axis -2 and the fused y*x (or y*x/2 for packed
fields) axis last, so a rank's block is a slice of those three axes:
spinors [T, 24, Z, Y*X], links [T, 4, 18, Z, Y*X], clover blocks
[T, 144, Z, Y*X] or [T, 2, 6, 6, 2, Z, Y*X], packed fields [T, 24, Z,
Y*X/2], evec batches [n, T, 24, Z, Y*X].
"""

from typing import Optional, Sequence

import torch

AXES = ("t", "z", "y")


class LatticeMesh:
    """Rank `rank`'s view of a (t, z[, y]) rank grid over a lattice.

    dims: global (X, Y, Z, T).  backend: the process group's backend
    ("nccl" or "gloo"), or None for a single rank without a process group
    (every exchange is then a local periodic copy and every reduction the
    identity; a mesh of more ranks without a group serves its geometry
    only).  device: the torch device of this rank's fields."""

    def __init__(self, mesh_shape: Sequence[int], dims: Sequence[int],
                 rank: int = 0, device="cuda", backend: Optional[str] = None):
        shape = tuple(int(n) for n in mesh_shape)
        if len(shape) not in (2, 3) or min(shape) < 1:
            raise ValueError(f"--mesh takes 2 or 3 positive extents over "
                             f"(t, z[, y]), got {list(mesh_shape)}")
        self.mesh_shape = shape
        self.shape = dict(zip(AXES, shape + (1,) * (3 - len(shape))))
        self.world = self.shape["t"] * self.shape["z"] * self.shape["y"]
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside the mesh {shape}")
        X, Y, Z, T = (int(d) for d in dims)
        self.dims = (X, Y, Z, T)
        self.global_ext = {"t": T, "z": Z, "y": Y}
        for a in AXES:
            if self.global_ext[a] % self.shape[a]:
                raise ValueError(
                    f"the mesh extent {self.shape[a]} along {a} does not "
                    f"divide the global extent {self.global_ext[a]}")
        self.local = {a: self.global_ext[a] // self.shape[a] for a in AXES}
        self.X = X
        self.rank = rank
        self.coords = self.coords_of(rank)
        self.origin = {a: self.coords[a] * self.local[a] for a in AXES}
        self.device = torch.device(device)
        self.backend = backend

    # --- geometry ---------------------------------------------------------

    def coords_of(self, rank: int) -> dict:
        nz, ny = self.shape["z"], self.shape["y"]
        return {"t": rank // (nz * ny), "z": (rank // ny) % nz,
                "y": rank % ny}

    def rank_of(self, coords: dict) -> int:
        c = {a: coords[a] % self.shape[a] for a in AXES}
        return (c["t"] * self.shape["z"] + c["z"]) * self.shape["y"] + c["y"]

    def neighbours(self, axis: str):
        """(previous, next) rank along `axis`, periodic."""
        prev, nxt = dict(self.coords), dict(self.coords)
        prev[axis] -= 1
        nxt[axis] += 1
        return self.rank_of(prev), self.rank_of(nxt)

    @property
    def z_ext(self) -> bool:
        """Local stencils read z neighbours from halo rows: the JAX 2D and
        3D forms (shard_op.py:32-37, :339)."""
        return self.shape["z"] > 1 or self.shape["y"] > 1

    @property
    def y_ext(self) -> bool:
        return self.shape["y"] > 1

    @property
    def local_dims(self):
        """Local (X, Y, Z, T)."""
        return (self.X, self.local["y"], self.local["z"], self.local["t"])

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def _block(self, shape, lead: int, rank: int):
        """Index of rank `rank`'s block in an array of global `shape`."""
        T, Z, Y = self.global_ext["t"], self.global_ext["z"], \
            self.global_ext["y"]
        if shape[lead] != T or shape[-2] != Z or shape[-1] % Y:
            raise ValueError(f"array shape {tuple(shape)} does not carry the "
                             f"global (T={T} on axis {lead}, Z={Z} on -2, "
                             f"Y*W on -1)")
        w = shape[-1] // Y                     # X, or X/2 when packed
        c = self.coords_of(rank)
        t0, z0, y0 = (c[a] * self.local[a] for a in AXES)
        idx = [slice(None)] * len(shape)
        idx[lead] = slice(t0, t0 + self.local["t"])
        idx[-2] = slice(z0, z0 + self.local["z"])
        idx[-1] = slice(y0 * w, (y0 + self.local["y"]) * w)
        return tuple(idx)

    def local_block(self, a, lead: int = 0):
        """This rank's block of a global kernel-layout array (numpy or
        torch; a view)."""
        return a[self._block(a.shape, lead, self.rank)]

    def ext_block(self, a, lead: int = 0, t: bool = True, z: bool = False,
                  y: bool = False, rank: Optional[int] = None):
        """A rank's block of a global kernel-layout array (numpy or torch)
        extended by one periodic halo slice per side along t (on axis
        `lead`), z and y (one row of the fused axis) where asked: what the
        halo exchange gives that rank.  A copy."""
        rank = self.rank if rank is None else rank
        T, Z, Y = (self.global_ext[k] for k in AXES)
        w = a.shape[-1] // Y
        c = self.coords_of(rank)
        t0, z0, y0 = (c[k] * self.local[k] for k in AXES)

        def span(o, n, L, ext):
            return [(o + i) % L for i in range(-int(ext), n + int(ext))]

        ys = span(y0, self.local["y"], Y, y)
        idx = ((lead, span(t0, self.local["t"], T, t)),
               (a.ndim - 2, span(z0, self.local["z"], Z, z)),
               (a.ndim - 1, [yy * w + x for yy in ys for x in range(w)]))
        for axis, ids in idx:
            if isinstance(a, torch.Tensor):
                a = a.index_select(axis, torch.as_tensor(ids,
                                                         device=a.device))
            else:
                a = a.take(ids, axis=axis)
        return a

    # --- collectives -----------------------------------------------------

    def _no_group(self) -> bool:
        if self.backend is None and self.world > 1:
            raise RuntimeError(f"a mesh of {self.world} ranks needs a "
                               f"process group (init_distributed)")
        return self.backend is None

    def _comm_tensor(self, t: torch.Tensor) -> torch.Tensor:
        # gloo takes CPU tensors here; NCCL device tensors
        return t.cpu() if self.backend == "gloo" else t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of `t` over all ranks (the identity on one rank); returns the
        sum on t's device."""
        if self._no_group():
            return t
        import torch.distributed as dist
        c = self._comm_tensor(t).contiguous()
        dist.all_reduce(c)
        return c.to(t.device)

    def gather_field(self, local: torch.Tensor, lead: int = 0):
        """The global array from every rank's block, on every rank (on
        local's device)."""
        shape = list(local.shape)
        shape[lead] = self.global_ext["t"]
        shape[-2] = self.global_ext["z"]
        shape[-1] = local.shape[-1] * self.shape["y"]
        if self._no_group():
            return local
        import torch.distributed as dist
        c = self._comm_tensor(local).contiguous()
        parts = [torch.empty_like(c) for _ in range(self.world)]
        dist.all_gather(parts, c)
        out = torch.empty(shape, dtype=local.dtype, device=c.device)
        for r, p in enumerate(parts):
            out[self._block(shape, lead, r)] = p
        return out.to(local.device)

    # --- coarse layout -----------------------------------------------------
    # An MG coarse array [Tc, Zc, Yc, Xc, ...] carries t, z and y on axes
    # 0, 1 and 2; a rank's block is an equal slice of each, since every
    # fine block lies inside one rank's block.

    def _coarse_index(self, shape, rank: int, local: bool):
        """Rank `rank`'s block of a coarse array whose leading extents are
        `shape` (global, or the block's with local=True)."""
        c = self.coords_of(rank)
        idx = []
        for i, a in enumerate(AXES):
            n = shape[i] if local else shape[i] // self.shape[a]
            idx.append(slice(c[a] * n, (c[a] + 1) * n))
        return tuple(idx)

    def local_coarse_block(self, a):
        """This rank's block of a global coarse array (a view)."""
        return a[self._coarse_index(a.shape, self.rank, False)]

    def gather_coarse(self, local: torch.Tensor) -> torch.Tensor:
        """The global coarse array from every rank's block, on every rank
        (one all-gather; on local's device): gather_field's counterpart for
        the coarse layout."""
        if self._no_group():
            return local
        import torch.distributed as dist
        c = self._comm_tensor(local).contiguous()
        parts = [torch.empty_like(c) for _ in range(self.world)]
        dist.all_gather(parts, c)
        shape = tuple(local.shape[i] * self.shape[a]
                      for i, a in enumerate(AXES)) + tuple(local.shape[3:])
        out = torch.empty(shape, dtype=local.dtype, device=c.device)
        for r, p in enumerate(parts):
            out[self._coarse_index(local.shape, r, True)] = p
        return out.to(local.device)


def make_lattice_mesh(mesh_shape: Sequence[int], dims: Sequence[int],
                      device="cuda") -> LatticeMesh:
    """The mesh of this process: its rank and backend from the initialised
    process group (init_distributed), or a single rank without one.  The
    mesh must hold exactly the group's ranks."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
    else:
        rank, world, backend = 0, 1, None
    mesh = LatticeMesh(mesh_shape, dims, rank=rank, device=device,
                       backend=backend)
    if mesh.world != world:
        raise ValueError(f"--mesh {' '.join(map(str, mesh_shape))} has "
                         f"{mesh.world} ranks but the process group has "
                         f"{world}")
    return mesh
