"""The local stencil of one rank's block with its halo exchange (port of
mugiq_tpu.parallel.shard_dslash: make_sharded_wilson_m, _2d, _3d, the bare
hop's make_sharded_dslash, _2d and make_sharded_wilson_3d(kappa=None), and
the interior/boundary split _overlap_apply).

The JAX package builds a halo-extended copy of the local block from
ppermuted slices and runs the Pallas stencil on it.  Here a preallocated
extended buffer [Tl+2, 24, Zp, Yp*W] of the block's dtype (f32, or bf16
for the vectors of a bf16 Krylov basis: the exchange then moves bf16, as
the JAX ppermutes do; :class:`ExtBuffers`) takes the block in its interior,
:class:`.halo.HaloExchange` fills its halos (y, then z, then t), and the
K7 kernels (kernels.wilson.wilson_m_halo, kernels.parity.parity_hop_halo)
or K4-halo (kernels.wilson.dslash_hop_halo) read it.  With ``overlap``
(the default, as in the JAX package) the interior rows 1..Tl-2, which read
no t halo, launch while the t halos
travel, and the two boundary rows after they arrive; every output site
runs the same arithmetic either way, so the two forms are bit-identical
(shard_dslash.py:308-312).  The JAX 3D form runs without the split
(:246-302); here every form splits.
"""

import torch

from ..kernels.wilson import dslash_hop_halo


def ext_dims(mesh, W: int):
    """(Zp, Yp*W) of a halo-extended block whose fused axis holds W
    elements per y row (X, or X/2 when packed)."""
    Zl, Yl = mesh.local["z"], mesh.local["y"]
    return (Zl + 2 if mesh.z_ext else Zl), \
        (Yl + 2 if mesh.y_ext else Yl) * W


class ExtBuffers:
    """An operator's halo-extended spinor buffers [Tl+2, 24, Zp, Yp*W], one
    per spinor dtype, each allocated at its first use: buffers(dtype)."""

    def __init__(self, mesh, W: int, device):
        self.shape = (mesh.local["t"] + 2, 24) + ext_dims(mesh, W)
        self.device = device
        self._bufs = {}

    def __call__(self, dtype) -> torch.Tensor:
        if dtype not in self._bufs:
            self._bufs[dtype] = torch.zeros(self.shape, dtype=dtype,
                                            device=self.device)
        return self._bufs[dtype]


def fill_interior(ext, src, mesh, W: int):
    """Copy src [Tl, C, Zl, Yl*W] into the interior of ext [Tl+2, C, Zp,
    Yp*W] (ext rows 1..Tl; z/y offset by one where extended)."""
    Tl, C, Zl, _ = src.shape
    Yl = mesh.local["y"]
    Zp, YWp = ext.shape[2], ext.shape[3]
    v = ext[1:Tl + 1].view(Tl, C, Zp, YWp // W, W)
    if mesh.z_ext:
        v = v[:, :, 1:Zl + 1]
    if mesh.y_ext:
        v = v[:, :, :, 1:Yl + 1]
    v.copy_(src.reshape(Tl, C, Zl, Yl, W))


def exchange_zy(halo, buf, mesh, W: int, zdim: int) -> None:
    """The y then z halos of a buffer whose z axis is `zdim` and fused axis
    `zdim + 1`, where the mesh extends them."""
    if mesh.y_ext:
        halo.exchange(buf, "y", zdim + 1, W)
    if mesh.z_ext:
        halo.exchange(buf, "z", zdim, 1)


def apply_halo(halo, ext, src, launch, mesh, W: int, overlap: bool = True):
    """Fill ext from src, exchange y -> z -> t, and launch the stencil:
    launch(rows) with rows (t0, nrows, tstep), or None for all rows."""
    fill_interior(ext, src, mesh, W)
    exchange_zy(halo, ext, mesh, W, 2)
    Tl = ext.shape[0] - 2
    if overlap and Tl >= 2:
        handle = halo.start(ext, "t", 0, 1)
        if Tl > 2:
            launch((1, Tl - 2, 1))              # interior: no t halo read
        halo.finish(handle)
        launch((0, 2, Tl - 1))                  # boundary rows 0 and Tl-1
    else:
        halo.exchange(ext, "t", 0, 1)
        launch(None)


def extend_links(halo, U_loc, mesh, W: int):
    """The block's links with their z/y halos, [Tl, 4, 18, Zp, Yp*W], and
    the t-links of the previous global row, Ut_shift[t] = U_t(t - 1) with
    the same halos ([Tl, 18, Zp, Yp*W]; row 0 comes from the previous t
    rank).  Links are constant: exchanged once, at operator build (the JAX
    package re-permutes them on every application, shard_dslash.py:434)."""
    Tl, _, _, Zl, _ = U_loc.shape
    Zp, YWp = ext_dims(mesh, W)
    tmp = torch.zeros((Tl + 2, 72, Zp, YWp), dtype=U_loc.dtype,
                      device=U_loc.device)
    fill_interior(tmp, U_loc.reshape(Tl, 72, Zl, -1), mesh, W)
    exchange_zy(halo, tmp, mesh, W, 2)
    U_ext = tmp[1:Tl + 1].reshape(Tl, 4, 18, Zp, YWp).clone()
    del tmp
    # Ut of the previous row: the t exchange brings the previous rank's
    # last row into row 0
    tb = torch.zeros((Tl + 2, 18, Zp, YWp), dtype=U_loc.dtype,
                     device=U_loc.device)
    tb[1:Tl + 1] = U_ext[:, 3]
    halo.exchange(tb, "t", 0, 1)
    return U_ext, tb[:Tl].contiguous()


def extend_along(halo, a, axis: str, dim: int, width: int):
    """A copy of `a` with `width` halo elements a side along `dim`, the
    array dimension of mesh axis `axis`, filled by one exchange."""
    shape = list(a.shape)
    shape[dim] += 2 * width
    ext = torch.empty(shape, dtype=a.dtype, device=a.device)
    ext.narrow(dim, width, a.shape[dim]).copy_(a)
    halo.exchange(ext, axis, dim, width)
    return ext


def partitioned_dirs(mesh, lead: int = 0):
    """{mu: (mesh axis, its dim in a link field [Tl, 4, 18, Zl, Yl*X], its
    dim in a spinor field [.., Tl, 24, Zl, Yl*X] with t on axis `lead`,
    halo width)} for each lattice direction the mesh partitions: what a
    one-direction stencil (K3, K5) extends by one slice a side, with
    extend_along, to read across the rank edges."""
    dirs = {1: ("y", 4, 3, mesh.X), 2: ("z", 3, 2, 1), 3: ("t", 0, 0, 1)}
    return {mu: (a, du, dp + lead, w) for mu, (a, du, dp, w) in dirs.items()
            if mesh.shape[a] > 1}


def make_sharded_dslash(mesh, halo, ext, dagger: bool = False,
                        overlap: bool = True):
    """The rank's bare hop D psi (dagger: D^dag psi) over any (t, z[, y])
    mesh: the three JAX factories make_sharded_dslash (t), _2d (t, z) and
    make_sharded_wilson_3d(kappa=None) (t, z, y) in one.  Returns
    hop(psi_loc, U_ext, Ut_shift) -> [Tl, 24, Zl, Yl*X] in psi_loc's dtype
    (f32 or bf16), with psi_loc the block [Tl, 24, Zl, Yl*X] and the links
    extended once by extend_links (the JAX functions take the raw links
    and re-permute them on every call).  halo, ext: the operator's
    exchange and ExtBuffers, shared with its M; overlap: the
    interior/boundary split."""
    Yl = mesh.local["y"]

    def hop(psi_loc, U_ext, Ut_shift):
        buf = ext(psi_loc.dtype)
        out = torch.empty_like(psi_loc)

        def launch(rows):
            dslash_hop_halo(buf, U_ext, Ut_shift, dagger, Yl, mesh.z_ext,
                            mesh.y_ext, rows=rows, out=out)

        apply_halo(halo, buf, psi_loc, launch, mesh, psi_loc.shape[3] // Yl,
                   overlap)
        return out

    return hop
