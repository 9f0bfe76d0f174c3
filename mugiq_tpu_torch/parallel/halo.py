"""Halo exchange between the ranks of a LatticeMesh (the communication half
of mugiq_tpu.parallel.shard_dslash, whose ppermutes this replaces).

A halo-extended buffer holds `width` halo elements on each side of one
dimension around its interior.  An exchange along a mesh axis sends the
first interior slice to the previous rank (its next halo) and the last
to the next rank (its previous halo), and receives its own two halos, one
slice per side.  Callers exchange y, then z, then t, over whole extended
extents, so the corner halos ride the later exchanges as in the JAX
package (shard_dslash.py:246-300).

* An axis of mesh extent 1 is a local periodic copy: a rank never sends
  to itself (gloo refuses it).
* NCCL: ``batch_isend_irecv`` of device tensors; the transfer runs on
  NCCL's stream and ``finish`` makes the current stream wait for it.
* gloo with CUDA tensors (ranks sharing a card): the slices are copied to
  pinned host buffers, sent by gloo, and copied back.  gloo gets no CUDA
  tensor.
* gloo with CPU tensors: the slices themselves.
Two sends to one peer (mesh extent 2) pair with the receives in posting
order (NCCL) and by tag (gloo).

:data:`TOTALS` counts, over every exchange of the process, the bytes sent
to other ranks, the host seconds spent inside the exchange calls and the
exchanges (:func:`reset_totals` zeroes them).
"""

import time

import torch

_TAG_TO_NEXT, _TAG_TO_PREV = 0, 1

TOTALS = {"bytes": 0, "seconds": 0.0, "exchanges": 0}


def reset_totals() -> None:
    TOTALS.update(bytes=0, seconds=0.0, exchanges=0)


class HaloExchange:
    def __init__(self, mesh):
        self.mesh = mesh
        self.staged = (mesh.backend == "gloo"
                       and mesh.device.type == "cuda")
        self._pinned = {}

    def _host(self, key, like):
        """A cached pinned host buffer shaped like `like`."""
        k = (key, tuple(like.shape), like.dtype)
        b = self._pinned.get(k)
        if b is None:
            b = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._pinned[k] = b
        return b

    def start(self, buf: torch.Tensor, axis: str, dim: int, width: int):
        """Post the exchange of `buf`'s halos along mesh `axis` (array
        dimension `dim`, `width` halo elements a side); returns a handle
        for :meth:`finish`."""
        t0 = time.perf_counter()
        n = buf.shape[dim]
        inner = n - 2 * width
        if inner < width:
            raise ValueError(f"halo exchange: {inner} interior elements on "
                             f"dim {dim} cannot fill a halo of {width}")
        first = buf.narrow(dim, width, width)
        last = buf.narrow(dim, n - 2 * width, width)
        halo_prev = buf.narrow(dim, 0, width)
        halo_next = buf.narrow(dim, n - width, width)
        TOTALS["exchanges"] += 1
        if self.mesh.shape[axis] == 1:
            halo_prev.copy_(last)
            halo_next.copy_(first)
            TOTALS["seconds"] += time.perf_counter() - t0
            return None
        import torch.distributed as dist

        prev, nxt = self.mesh.neighbours(axis)
        if self.staged:
            s_last = self._host(("s_last", axis, dim), last)
            s_first = self._host(("s_first", axis, dim), first)
            r_prev = self._host(("r_prev", axis, dim), halo_prev)
            r_next = self._host(("r_next", axis, dim), halo_next)
            s_last.copy_(last, non_blocking=True)
            s_first.copy_(first, non_blocking=True)
            # the host buffers are read by gloo and the receive buffers
            # of the previous exchange copied back: both need the stream
            torch.cuda.current_stream(buf.device).synchronize()
        else:
            s_last, s_first = last.contiguous(), first.contiguous()

            def into(h):        # receive in place where the halo is dense
                return h if h.is_contiguous() else torch.empty(
                    h.shape, dtype=h.dtype, device=h.device)

            r_prev, r_next = into(halo_prev), into(halo_next)
        ops = [dist.P2POp(dist.isend, s_last, nxt, tag=_TAG_TO_NEXT),
               dist.P2POp(dist.isend, s_first, prev, tag=_TAG_TO_PREV),
               dist.P2POp(dist.irecv, r_prev, prev, tag=_TAG_TO_NEXT),
               dist.P2POp(dist.irecv, r_next, nxt, tag=_TAG_TO_PREV)]
        works = dist.batch_isend_irecv(ops)
        TOTALS["bytes"] += 2 * last.numel() * last.element_size()
        TOTALS["seconds"] += time.perf_counter() - t0
        return (works, (r_prev, halo_prev), (r_next, halo_next),
                (s_last, s_first))

    def finish(self, handle) -> None:
        """Wait for a posted exchange and place its halos."""
        if handle is None:
            return
        t0 = time.perf_counter()
        works, *pairs, _ = handle
        for w in works:
            w.wait()
        for got, halo in pairs:
            if got.data_ptr() != halo.data_ptr():
                halo.copy_(got, non_blocking=self.staged)
        TOTALS["seconds"] += time.perf_counter() - t0

    def exchange(self, buf: torch.Tensor, axis: str, dim: int,
                 width: int) -> None:
        """Blocking :meth:`start` + :meth:`finish`."""
        self.finish(self.start(buf, axis, dim, width))
