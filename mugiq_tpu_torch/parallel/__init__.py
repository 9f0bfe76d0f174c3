"""The sharded (domain-decomposed) production path over torch.distributed.

One process per rank; each rank holds its local block of the lattice in
the kernel layouts.  :mod:`.mesh` maps ranks to (t, z[, y]) blocks,
:mod:`.distributed` starts the process group, :mod:`.halo` exchanges
boundary slices, :mod:`.shard_dslash` applies the halo-extended stencils
(K7) and :mod:`.shard_op` holds the sharded operators.
"""
