"""stencil_roofline: the operator stencils' share of their roofline, in %:
sum of launches x bound / sum of the stencils' device time.

A launch's bound is the larger of its bytes at the HBM rate and its float32
operations at the float32 rate (portbench/peaks.py): each input read once,
each output written once (a stencil also reads every neighbour spinor
again, which no bound counts).  The bytes come from the lattice and the
instance's types, read from the kernel's template arguments in its device
name; the launches and the time from the trace, by the name patterns of
STENCILS, so that each launch counted is a launch timed.  ``bound_seconds`` also holds K2 and K3, the
measurement kernels, which are not stencils.

Only one-vector instances are counted (``*_direct_kernel`` is also the
batched bf16 form, the batch in grid y, and ``*_staged_kernel`` tiles a
batch whose size the name does not carry): a cell that runs none of these
stencils reads nothing.
"""

import math

from portbench import peaks

#: device name pattern -> kernel
STENCILS = {
    "wilson_m_direct_kernel<": "K1",
    "hop_dir_kernel<": "K5",
}
#: flop per site (the Wilson hop's 1320, the diagonal's 48; a directed hop
#: is an eighth of the hop)
FLOP_PER_SITE = {"K1": 1368, "K5": 165}


def _size(tname: str) -> int:
    return 2 if "bfloat16" in tname else 4


def template_args(name: str, pattern: str) -> list:
    """The template arguments after `pattern` (which ends in '<')."""
    i = name.index(pattern) + len(pattern)
    depth, cur, out = 1, "", []
    for ch in name[i:]:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
            if depth == 0:
                break
        if ch == "," and depth == 1:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    out.append(cur.strip())
    return out


def bytes_per_site(kernel: str, args: list) -> int:
    """Bytes a site moves in one launch of one vector.  K1 <DAG, CLOVER, K,
    link type, spinor type>: psi in, out, the four links a site owns (the
    eight hops read each link once) and the clover blocks; K5 <DAG, link
    type>: psi in, out, the one link of its direction."""
    if kernel == "K1":
        clover = args[1] == "true"
        lt, pt = _size(args[3]), _size(args[4])
        return 2 * 24 * pt + 72 * lt + (144 * lt if clover else 0)
    if kernel == "K5":
        return 2 * 24 * 4 + 18 * _size(args[1])
    raise ValueError(kernel)


def bound_seconds(kernel: str, sites: int, args=None, n_vec: int = 1) -> float:
    """The least time a launch could take on one H100 at `sites` sites.
    K2 (loop_contract: two batches of n_vec f32 vectors and the weights in,
    the 32 spin-pair sums out) and K3 (covariant_displace: n_vec vectors and
    one direction's f32 links in, n_vec vectors out) are counted too."""
    if kernel in ("K1", "K5"):
        b = bytes_per_site(kernel, args) * sites
        f = FLOP_PER_SITE[kernel] * sites
    elif kernel == "K2":
        b = (2 * n_vec * 96 + 128) * sites + 4 * n_vec
        f = n_vec * 16 * 3 * 8 * sites
    elif kernel == "K3":
        b = (2 * n_vec * 96 + 72) * sites
        f = n_vec * 4 * 66 * sites
    else:
        raise ValueError(kernel)
    return max(b / peaks.HBM_BYTES_PER_S, f / peaks.F32_FLOP_PER_S)


def read(run):
    t = run.traced
    if t is None:
        return None
    sites = math.prod(run.cell.config["dims"])
    bound = time_s = 0.0
    for name, (secs, n) in t.by_kernel.items():
        for pat, kernel in STENCILS.items():
            if pat in name:
                bound += n * bound_seconds(kernel, sites,
                                           template_args(name, pat))
                time_s += secs
    if time_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / time_s
