"""The CUDA kernels against their plain PyTorch twins on the card.

Runs only where CUDA is available (marked gpu; each test skips without a
device).  The file imports no JAX, so it runs on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Small odd extents exercise every periodic wrap of the index arithmetic;
K6 needs even ones (the checkerboard), distinct so that no two axes can be
confused.  K7a and K7b run on the block of a rank away from the origin of
each mesh kind (t; t and z; t, z and y halos), with the interior and
boundary row launches held to the single pass bit for bit; K4-halo
likewise, and K4 in all 16 type variants; the bf16-spinor forms of all
three (bf16 out, f32 and bf16 links) likewise, within 2^-7 of max |out|,
each launch counted in launches and in bf16_launches.  Tolerances are
f32 summation order only: K1, K4, K5 and K6 2e-5 of max |out| (up to
~100 terms per output, half-spinor vs full-projector form, K6's twin at
full volume), K2 2e-6, K3 1e-6; a bf16 output of K1, K4 or K6 one bf16
ulp of the largest output (2^-7 of max |out|).  K1's and K6's batched launch (a block of
fields in one launch) equals single launches exactly, for every batch
size the tiles cover (a partial last tile too), every spinor and link
type and every mode; bf16 pairs and the one-site instance where pairs
are illegal (odd X, a misaligned base) are held to their twins, for K1,
K6, K4, K7a and K4-halo.
"""

import pytest
import torch

from mugiq_tpu_torch.kernels.hop_dir import (dslash_hop_dir,
                                             dslash_hop_dir_plain)
from mugiq_tpu_torch.kernels.parity import parity_hop, parity_hop_plain
from mugiq_tpu_torch.kernels.contract import (
    covariant_displace, covariant_displace_plain, loop_contract,
    loop_contract_plain)
from mugiq_tpu_torch.kernels.parity import (parity_hop_halo,
                                            parity_hop_halo_plain)
from mugiq_tpu_torch.kernels.wilson import (dslash_hop, dslash_hop_halo,
                                            dslash_hop_halo_plain,
                                            dslash_hop_plain, wilson_m,
                                            wilson_m_halo,
                                            wilson_m_halo_plain, wilson_m_plain)
from mugiq_tpu_torch.params import parse_disp_str
from mugiq_tpu_torch.parallel.mesh import LatticeMesh

from torch_ref import cuda_device, rand

DIRS = ["+x", "-x", "+y", "-y", "+z", "-z", "+t", "-t"]


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("clover", [False, True])
@pytest.mark.parametrize("dagger", [False, True])
def test_kernel_matches_twin_on_card(prec, clover, dagger):
    dev = cuda_device()
    T, Z, Y, X = 4, 3, 5, 6
    dt = torch.bfloat16 if prec == "bf16" else torch.float32
    psi = torch.from_numpy(rand((T, 24, Z, Y * X), 1)).to(dev)
    U = torch.from_numpy(rand((T, 4, 18, Z, Y * X), 2, 0.5)).to(dev).to(dt)
    A = (torch.from_numpy(rand((T, 144, Z, Y * X), 3, 0.2)).to(dev).to(dt)
         if clover else None)
    ref = wilson_m_plain(psi, U, A, 0.13, dagger, Y)
    n0 = wilson_m.launches
    got = wilson_m(psi, U, A, 0.13, dagger, Y)
    torch.cuda.synchronize()
    assert wilson_m.launches == n0 + 1
    assert float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max())


@pytest.mark.gpu
def test_contract_kernel_matches_twin_on_card():
    dev = cuda_device()
    n, t, z, y, x = 5, 3, 3, 5, 7
    L = torch.from_numpy(rand((n, t, 24, z, y * x), 1)).to(dev)
    R = torch.from_numpy(rand((n, t, 24, z, y * x), 2)).to(dev)
    w = torch.linspace(0.5, 1.5, n, device=dev)
    ref = loop_contract_plain(L, R, w)
    n0 = loop_contract.launches
    got = loop_contract(L, R, w)
    torch.cuda.synchronize()
    assert loop_contract.launches == n0 + 1
    assert float((got - ref).abs().max()) <= 2e-6 * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dstr", DIRS)
def test_displace_kernel_matches_twin_on_card(dstr):
    dev = cuda_device()
    n, t, z, y, x = 2, 3, 3, 5, 7
    psi = torch.from_numpy(rand((n, t, 24, z, y * x), 1)).to(dev)
    U = torch.from_numpy(rand((t, 4, 18, z, y * x), 2, 0.5)).to(dev)
    mu, sgn = parse_disp_str(dstr)
    ref = covariant_displace_plain(psi, U, mu, sgn, y)
    n0 = covariant_displace.launches
    got = covariant_displace(psi, U, mu, sgn, y)
    torch.cuda.synchronize()
    assert covariant_displace.launches == n0 + 1
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["hop", "post", "comb", "comb_clover"])
@pytest.mark.parametrize("dagger", [False, True])
@pytest.mark.parametrize("parity_out", [0, 1])
def test_parity_hop_matches_twin_on_card(prec, mode, dagger, parity_out):
    dev = cuda_device()
    T, Z, Y, Xh = 4, 2, 6, 4
    dt = torch.bfloat16 if prec == "bf16" else torch.float32
    psi = torch.from_numpy(rand((T, 24, Z, Y * Xh), 1)).to(dev)
    Uo = torch.from_numpy(rand((T, 4, 18, Z, Y * Xh), 2, 0.5)).to(dev).to(dt)
    Ui = torch.from_numpy(rand((T, 4, 18, Z, Y * Xh), 3, 0.5)).to(dev).to(dt)
    A = torch.from_numpy(rand((T, 144, Z, Y * Xh), 4, 0.2)).to(dev).to(dt)
    pe = torch.from_numpy(rand((T, 24, Z, Y * Xh), 5)).to(dev)
    kw = {"hop": {}, "post": dict(A_post=A),
          "comb": dict(kappa2=0.0169, psi_out=pe),
          "comb_clover": dict(kappa2=0.0169, psi_out=pe, A_comb=A)}[mode]
    ref = parity_hop_plain(psi, Uo, Ui, Y, parity_out, dagger, **kw)
    n0 = parity_hop.launches
    got = parity_hop(psi, Uo, Ui, Y, parity_out, dagger, **kw)
    torch.cuda.synchronize()
    assert parity_hop.launches == n0 + 1
    assert float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("dagger", [False, True])
@pytest.mark.parametrize("dstr", DIRS)
def test_hop_dir_matches_twin_on_card(prec, dagger, dstr):
    dev = cuda_device()
    T, Z, Y, X = 4, 3, 5, 6
    dt = torch.bfloat16 if prec == "bf16" else torch.float32
    psi = torch.from_numpy(rand((T, 24, Z, Y * X), 1)).to(dev)
    U = torch.from_numpy(rand((T, 4, 18, Z, Y * X), 2, 0.5)).to(dev).to(dt)
    mu, sgn = parse_disp_str(dstr)
    ref = dslash_hop_dir_plain(psi, U, mu, sgn, dagger, Y)
    n0 = dslash_hop_dir.launches
    got = dslash_hop_dir(psi, U, mu, sgn, dagger, Y)
    torch.cuda.synchronize()
    assert dslash_hop_dir.launches == n0 + 1
    assert float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("psi_t", ["f32", "bf16"])
@pytest.mark.parametrize("link_t", ["f32", "bf16"])
@pytest.mark.parametrize("out_t", ["f32", "bf16"])
@pytest.mark.parametrize("dagger", [False, True])
def test_dslash_hop_matches_twin_on_card(psi_t, link_t, out_t, dagger):
    dev = cuda_device()
    T, Z, Y, X = 4, 3, 5, 6
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    psi = torch.from_numpy(rand((T, 24, Z, Y * X), 1)).to(dev).to(dt[psi_t])
    U = torch.from_numpy(rand((T, 4, 18, Z, Y * X), 2, 0.5)).to(dev).to(
        dt[link_t])
    ref = dslash_hop_plain(psi, U, dagger, Y, dt[out_t])
    n0 = dslash_hop.launches
    got = dslash_hop(psi, U, dagger, Y, out_dtype=dt[out_t])
    torch.cuda.synchronize()
    assert dslash_hop.launches == n0 + 1
    assert got.dtype == dt[out_t]
    tol = 2.0 ** -7 if out_t == "bf16" else 2e-5
    assert float((got.float() - ref.float()).abs().max()) <= \
        tol * float(ref.float().abs().max())


MESH_KINDS = [(2, 1), (2, 2), (2, 2, 2)]


def _far_rank(mesh, dims):
    m = LatticeMesh(mesh, dims)
    return m.rank_of({a: n - 1 for a, n in m.shape.items()})


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", MESH_KINDS, ids=str)
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("clover", [False, True])
@pytest.mark.parametrize("dagger", [False, True])
def test_wilson_m_halo_matches_twin_on_card(mesh, prec, clover, dagger):
    dev = cuda_device()
    dims = (5, 6, 4, 8)                     # X, Y, Z, T
    X, Y, Z, T = dims
    dt = torch.bfloat16 if prec == "bf16" else torch.float32
    psi = torch.from_numpy(rand((T, 24, Z, Y * X), 1)).to(dev)
    U = torch.from_numpy(rand((T, 4, 18, Z, Y * X), 2, 0.5)).to(dev).to(dt)
    A = torch.from_numpy(rand((T, 144, Z, Y * X), 3, 0.2)).to(dev).to(dt)
    m = LatticeMesh(mesh, dims, rank=_far_rank(mesh, dims), device=dev)
    ze, ye, Yl, Tl = m.z_ext, m.y_ext, m.local["y"], m.local["t"]
    args = (m.ext_block(psi, t=True, z=ze, y=ye),
            m.ext_block(U, t=False, z=ze, y=ye),
            m.ext_block(torch.roll(U[:, 3], 1, 0), t=False, z=ze, y=ye),
            m.local_block(A).contiguous() if clover else None, 0.13, dagger,
            Yl, ze, ye)
    ref = wilson_m_halo_plain(*args)
    n0 = wilson_m_halo.launches
    got = wilson_m_halo(*args)
    split = torch.full_like(got, float("nan"))
    wilson_m_halo(*args, rows=(1, Tl - 2, 1), out=split)
    wilson_m_halo(*args, rows=(0, 2, Tl - 1), out=split)
    torch.cuda.synchronize()
    assert wilson_m_halo.launches == n0 + 3
    assert float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max())
    assert torch.equal(split, got)


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", MESH_KINDS, ids=str)
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["hop", "post", "comb", "comb_clover"])
@pytest.mark.parametrize("dagger", [False, True])
def test_parity_hop_halo_matches_twin_on_card(mesh, prec, mode, dagger):
    dev = cuda_device()
    dims = (6, 4, 4, 8)                     # X, Y, Z, T; even blocks
    X, Y, Z, T = dims
    Xh = X // 2
    dt = torch.bfloat16 if prec == "bf16" else torch.float32
    psi = torch.from_numpy(rand((T, 24, Z, Y * Xh), 1)).to(dev)
    Uo = torch.from_numpy(rand((T, 4, 18, Z, Y * Xh), 2, 0.5)).to(dev).to(dt)
    Ui = torch.from_numpy(rand((T, 4, 18, Z, Y * Xh), 3, 0.5)).to(dev).to(dt)
    A = torch.from_numpy(rand((T, 144, Z, Y * Xh), 4, 0.2)).to(dev).to(dt)
    pe = torch.from_numpy(rand((T, 24, Z, Y * Xh), 5)).to(dev)
    m = LatticeMesh(mesh, dims, rank=_far_rank(mesh, dims), device=dev)
    ze, ye, Tl = m.z_ext, m.y_ext, m.local["t"]
    blk = lambda a: m.local_block(a).contiguous()  # noqa: E731
    kw = {"hop": {}, "post": dict(A_post=blk(A)),
          "comb": dict(kappa2=0.0169, psi_out=blk(pe)),
          "comb_clover": dict(kappa2=0.0169, psi_out=blk(pe),
                              A_comb=blk(A))}[mode]
    po = 1 if mode in ("hop", "post") else 0
    args = (m.ext_block(psi, t=True, z=ze, y=ye),
            m.ext_block(Uo, t=False, z=ze, y=ye),
            m.ext_block(Ui, t=False, z=ze, y=ye),
            m.ext_block(torch.roll(Ui[:, 3], 1, 0), t=False, z=ze, y=ye),
            m.local["y"], po, dagger, ze, ye)
    ref = parity_hop_halo_plain(*args, **kw)
    n0 = parity_hop_halo.launches
    got = parity_hop_halo(*args, **kw)
    split = torch.full_like(got, float("nan"))
    parity_hop_halo(*args, **kw, rows=(1, Tl - 2, 1), out=split)
    parity_hop_halo(*args, **kw, rows=(0, 2, Tl - 1), out=split)
    torch.cuda.synchronize()
    assert parity_hop_halo.launches == n0 + 3
    assert float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max())
    assert torch.equal(split, got)


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", MESH_KINDS, ids=str)
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("dagger", [False, True])
def test_dslash_hop_halo_matches_twin_on_card(mesh, prec, dagger):
    dev = cuda_device()
    dims = (5, 6, 4, 8)                     # X, Y, Z, T
    X, Y, Z, T = dims
    dt = torch.bfloat16 if prec == "bf16" else torch.float32
    psi = torch.from_numpy(rand((T, 24, Z, Y * X), 1)).to(dev)
    U = torch.from_numpy(rand((T, 4, 18, Z, Y * X), 2, 0.5)).to(dev).to(dt)
    m = LatticeMesh(mesh, dims, rank=_far_rank(mesh, dims), device=dev)
    ze, ye, Yl, Tl = m.z_ext, m.y_ext, m.local["y"], m.local["t"]
    args = (m.ext_block(psi, t=True, z=ze, y=ye),
            m.ext_block(U, t=False, z=ze, y=ye),
            m.ext_block(torch.roll(U[:, 3], 1, 0), t=False, z=ze, y=ye),
            dagger, Yl, ze, ye)
    ref = dslash_hop_halo_plain(*args)
    n0 = dslash_hop_halo.launches
    got = dslash_hop_halo(*args)
    split = torch.full_like(got, float("nan"))
    dslash_hop_halo(*args, rows=(1, Tl - 2, 1), out=split)
    dslash_hop_halo(*args, rows=(0, 2, Tl - 1), out=split)
    torch.cuda.synchronize()
    assert dslash_hop_halo.launches == n0 + 3
    assert float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max())
    assert torch.equal(split, got)


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", MESH_KINDS, ids=str)
@pytest.mark.parametrize("link_t", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["k7a", "k4h", "k7b"])
def test_halo_bf16_spinors_match_twin_on_card(mesh, link_t, kernel):
    """bf16 psi_ext: K7a (clover M^dag), K4-halo (D^dag), K7b (pass 2 with
    A_comb, M^dag) write bf16 within 2^-7 of max |out| of their twins, the
    split equal to the single pass."""
    dev = cuda_device()
    dims = (6, 4, 4, 8) if kernel == "k7b" else (5, 6, 4, 8)
    X, Y, Z, T = dims
    W = X // 2 if kernel == "k7b" else X
    bf = torch.bfloat16
    psi = torch.from_numpy(rand((T, 24, Z, Y * W), 1)).to(dev).to(bf)
    U = torch.from_numpy(rand((T, 4, 18, Z, Y * W), 2, 0.5)).to(dev).to(
        link_t)
    A = torch.from_numpy(rand((T, 144, Z, Y * W), 3, 0.2)).to(dev).to(link_t)
    m = LatticeMesh(mesh, dims, rank=_far_rank(mesh, dims), device=dev)
    ze, ye, Yl, Tl = m.z_ext, m.y_ext, m.local["y"], m.local["t"]
    ext = dict(z=ze, y=ye)
    pe = m.ext_block(psi, t=True, **ext)
    Ue = m.ext_block(U, t=False, **ext)
    Ute = m.ext_block(torch.roll(U[:, 3], 1, 0), t=False, **ext)
    Al = m.local_block(A).contiguous()
    if kernel == "k7a":
        fn, plain, k = wilson_m_halo, wilson_m_halo_plain, (
            pe, Ue, Ute, Al, 0.13, True, Yl, ze, ye)
        kw = {}
    elif kernel == "k4h":
        fn, plain, k = dslash_hop_halo, dslash_hop_halo_plain, (
            pe, Ue, Ute, True, Yl, ze, ye)
        kw = {}
    else:
        Ui = torch.from_numpy(rand((T, 4, 18, Z, Y * W), 4, 0.5)).to(
            dev).to(link_t)
        fn, plain, k = parity_hop_halo, parity_hop_halo_plain, (
            pe, Ue, m.ext_block(Ui, t=False, **ext),
            m.ext_block(torch.roll(Ui[:, 3], 1, 0), t=False, **ext), Yl, 0,
            True, ze, ye)
        pout = torch.from_numpy(rand((T, 24, Z, Y * W), 5)).to(dev).to(bf)
        kw = dict(kappa2=0.0169, psi_out=m.local_block(pout).contiguous(),
                  A_comb=Al)
    ref = plain(*k, **kw)
    n0, b0 = fn.launches, fn.bf16_launches
    got = fn(*k, **kw)
    split = torch.full_like(got, float("nan"))
    fn(*k, **kw, rows=(1, Tl - 2, 1), out=split)
    fn(*k, **kw, rows=(0, 2, Tl - 1), out=split)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 3 and fn.bf16_launches == b0 + 3
    assert got.dtype == ref.dtype == bf
    assert float((got.float() - ref.float()).abs().max()) <= \
        2.0 ** -7 * float(ref.float().abs().max())
    assert torch.equal(split, got)


@pytest.mark.gpu
@pytest.mark.parametrize("link_t", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clover", [False, True])
@pytest.mark.parametrize("dagger", [False, True])
def test_bf16_spinor_k1_matches_twin_on_card(link_t, clover, dagger):
    dev = cuda_device()
    T, Z, Y, X = 4, 3, 5, 6
    psi = torch.from_numpy(rand((T, 24, Z, Y * X), 1)).to(dev).bfloat16()
    U = torch.from_numpy(rand((T, 4, 18, Z, Y * X), 2, 0.5)).to(dev).to(
        link_t)
    A = (torch.from_numpy(rand((T, 144, Z, Y * X), 3, 0.2)).to(dev).to(
        link_t) if clover else None)
    ref = wilson_m_plain(psi, U, A, 0.13, dagger, Y)
    got = wilson_m(psi, U, A, 0.13, dagger, Y)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert float((got.float() - ref.float()).abs().max()) <= \
        2.0 ** -7 * float(ref.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("spinor_t", [torch.float32, torch.bfloat16])
def test_batched_k1_and_k6_equal_single_launches_on_card(spinor_t):
    dev = cuda_device()
    T, Z, Y, X = 4, 2, 6, 8
    psi = torch.from_numpy(rand((3, T, 24, Z, Y * X), 1)).to(dev).to(
        spinor_t)
    U = torch.from_numpy(rand((T, 4, 18, Z, Y * X), 2, 0.5)).to(dev)
    n0 = wilson_m.launches
    got = wilson_m(psi, U, None, 0.13, False, Y)
    assert wilson_m.launches == n0 + 1
    assert torch.equal(got, torch.stack([wilson_m(p, U, None, 0.13, False, Y)
                                         for p in psi]))
    pin = psi[..., :Y * X // 2].contiguous()
    Uh = U[..., :Y * X // 2].contiguous()
    n0 = parity_hop.launches
    got = parity_hop(pin, Uh, Uh, Y, 0, True, kappa2=0.02, psi_out=pin)
    assert parity_hop.launches == n0 + 1
    ref = parity_hop_plain(pin, Uh, Uh, Y, 0, True, kappa2=0.02, psi_out=pin)
    one = torch.stack([parity_hop(p, Uh, Uh, Y, 0, True, kappa2=0.02,
                                  psi_out=p) for p in pin])
    torch.cuda.synchronize()
    assert torch.equal(got, one)
    tol = 2.0 ** -7 if spinor_t == torch.bfloat16 else 2e-5
    assert float((got.float() - ref.float()).abs().max()) <= \
        tol * float(ref.float().abs().max())


BATCHES = [1, 2, 3, 4, 5, 8]
DT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _close(got, ref, spinor_t):
    tol = 2.0 ** -7 if spinor_t == "bf16" else 2e-5
    return float((got.float() - ref.float()).abs().max()) <= \
        tol * float(ref.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("spinor_t", ["f32", "bf16"])
@pytest.mark.parametrize("link_t", ["f32", "bf16"])
@pytest.mark.parametrize("clover", [False, True])
@pytest.mark.parametrize("dagger", [False, True])
def test_k1_tiles_equal_single_launches_on_card(b, spinor_t, link_t, clover,
                                                dagger):
    """A batch (block tiles of four vectors, f32 or paired bf16, a partial
    last tile) equals single launches bit for bit and the twin within its
    tolerance; X even with odd Y and Z, so bf16 pairs wrap at row ends."""
    dev = cuda_device()
    T, Z, Y, X = 4, 3, 5, 6
    psi = torch.from_numpy(rand((b, T, 24, Z, Y * X), 1)).to(dev).to(
        DT[spinor_t])
    U = torch.from_numpy(rand((T, 4, 18, Z, Y * X), 2, 0.5)).to(dev).to(
        DT[link_t])
    A = (torch.from_numpy(rand((T, 144, Z, Y * X), 3, 0.2)).to(dev).to(
        DT[link_t]) if clover else None)
    n0 = wilson_m.launches
    got = wilson_m(psi, U, A, 0.13, dagger, Y)
    assert wilson_m.launches == n0 + 1
    one = torch.stack([wilson_m(p, U, A, 0.13, dagger, Y) for p in psi])
    ref = wilson_m_plain(psi, U, A, 0.13, dagger, Y)
    torch.cuda.synchronize()
    assert torch.equal(got, one)
    assert _close(got, ref, spinor_t)


@pytest.mark.gpu
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("spinor_t", ["f32", "bf16"])
@pytest.mark.parametrize("link_t", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["hop", "post", "comb", "comb_clover"])
@pytest.mark.parametrize("dagger", [False, True])
def test_k6_tiles_equal_single_launches_on_card(b, spinor_t, link_t, mode,
                                                dagger):
    """K6, every mode: a batch equals single launches bit for bit and the
    twin within its tolerance (Xh = 4: both pair offsets)."""
    dev = cuda_device()
    T, Z, Y, Xh = 4, 2, 6, 4
    sdt, ldt = DT[spinor_t], DT[link_t]
    psi = torch.from_numpy(rand((b, T, 24, Z, Y * Xh), 1)).to(dev).to(sdt)
    pe = torch.from_numpy(rand((b, T, 24, Z, Y * Xh), 5)).to(dev).to(sdt)
    Uo = torch.from_numpy(rand((T, 4, 18, Z, Y * Xh), 2, 0.5)).to(dev).to(ldt)
    Ui = torch.from_numpy(rand((T, 4, 18, Z, Y * Xh), 3, 0.5)).to(dev).to(ldt)
    A = torch.from_numpy(rand((T, 144, Z, Y * Xh), 4, 0.2)).to(dev).to(ldt)

    def kw(i=None):
        e = pe if i is None else pe[i]
        return {"hop": {}, "post": dict(A_post=A),
                "comb": dict(kappa2=0.0169, psi_out=e),
                "comb_clover": dict(kappa2=0.0169, psi_out=e,
                                    A_comb=A)}[mode]

    po = 1 if mode in ("hop", "post") else 0
    n0 = parity_hop.launches
    got = parity_hop(psi, Uo, Ui, Y, po, dagger, **kw())
    assert parity_hop.launches == n0 + 1
    one = torch.stack([parity_hop(p, Uo, Ui, Y, po, dagger, **kw(i))
                       for i, p in enumerate(psi)])
    ref = parity_hop_plain(psi, Uo, Ui, Y, po, dagger, **kw())
    torch.cuda.synchronize()
    assert torch.equal(got, one)
    assert _close(got, ref, spinor_t)


def _misaligned(a):
    """A copy of `a` whose base is one element past a four-byte boundary."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    v = buf[1:].view(a.shape)
    v.copy_(a)
    return v


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["x2", "odd_x", "misaligned"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("clover", [False, True])
def test_k1_bf16_pair_and_one_site_on_card(case, b, clover):
    """bf16 spinors: pairs at X = 2 (both x wraps inside one pair), and the
    one-site instance where pairs are illegal (X = 5; a base two bytes off
    a four-byte boundary), each within one bf16 ulp of the twin."""
    from mugiq_tpu_torch.kernels.wilson import aligned_pairs, launch_plan
    dev = cuda_device()
    T, Z, Y = 4, 3, 5
    X = {"x2": 2, "odd_x": 5, "misaligned": 6}[case]
    psi = torch.from_numpy(rand((b, T, 24, Z, Y * X), 1)).to(dev).bfloat16()
    U = torch.from_numpy(rand((T, 4, 18, Z, Y * X), 2, 0.5)).to(dev).bfloat16()
    A = (torch.from_numpy(rand((T, 144, Z, Y * X), 3, 0.2)).to(dev)
         .bfloat16() if clover else None)
    if case == "misaligned":
        psi = _misaligned(psi)
    plan = launch_plan("wilson_m", b, X, True, aligned_pairs(psi, U, A))
    assert plan.pair == (case == "x2")
    got = wilson_m(psi, U, A, 0.13, False, Y)
    one = torch.stack([wilson_m(p, U, A, 0.13, False, Y) for p in psi])
    ref = wilson_m_plain(psi, U, A, 0.13, False, Y)
    torch.cuda.synchronize()
    assert torch.equal(got, one)
    assert _close(got, ref, "bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["hop", "comb_clover"])
def test_k6_bf16_one_site_misaligned_on_card(mode):
    """K6 with a bf16 base two bytes off a four-byte boundary takes the
    one-site instance, within one bf16 ulp of the twin."""
    dev = cuda_device()
    T, Z, Y, Xh = 4, 2, 6, 4
    psi = _misaligned(torch.from_numpy(rand((T, 24, Z, Y * Xh), 1)).to(dev)
                      .bfloat16())
    pe = torch.from_numpy(rand((T, 24, Z, Y * Xh), 5)).to(dev).bfloat16()
    Uo = torch.from_numpy(rand((T, 4, 18, Z, Y * Xh), 2, 0.5)).to(dev)
    Ui = torch.from_numpy(rand((T, 4, 18, Z, Y * Xh), 3, 0.5)).to(dev)
    A = torch.from_numpy(rand((T, 144, Z, Y * Xh), 4, 0.2)).to(dev)
    kw = ({} if mode == "hop"
          else dict(kappa2=0.0169, psi_out=pe, A_comb=A))
    po = 1 if mode == "hop" else 0
    got = parity_hop(psi, Uo, Ui, Y, po, False, **kw)
    ref = parity_hop_plain(psi, Uo, Ui, Y, po, False, **kw)
    torch.cuda.synchronize()
    assert _close(got, ref, "bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["x2", "odd_x", "misaligned"])
@pytest.mark.parametrize("link_t", ["f32", "bf16"])
@pytest.mark.parametrize("out_t", ["f32", "bf16"])
@pytest.mark.parametrize("dagger", [False, True])
def test_k4_bf16_pair_and_one_site_on_card(case, link_t, out_t, dagger):
    """K4 with bf16 spinors: pairs at X = 2 (both x wraps inside one pair),
    and the one-site instance where pairs are illegal (X = 5; a base two
    bytes off a four-byte boundary), each within its tolerance of the
    twin."""
    from mugiq_tpu_torch.kernels.wilson import aligned_pairs, launch_plan
    dev = cuda_device()
    T, Z, Y = 4, 3, 5
    X = {"x2": 2, "odd_x": 5, "misaligned": 6}[case]
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    psi = torch.from_numpy(rand((T, 24, Z, Y * X), 1)).to(dev).bfloat16()
    U = torch.from_numpy(rand((T, 4, 18, Z, Y * X), 2, 0.5)).to(dev).to(
        dt[link_t])
    if case == "misaligned":
        psi = _misaligned(psi)
    out = torch.empty(psi.shape, dtype=dt[out_t], device=dev)
    plan = launch_plan("dslash_hop", 1, X, True, aligned_pairs(psi, U, out))
    assert plan.pair == (case == "x2")
    ref = dslash_hop_plain(psi, U, dagger, Y, dt[out_t])
    n0 = dslash_hop.launches
    got = dslash_hop(psi, U, dagger, Y, out=out)
    torch.cuda.synchronize()
    assert dslash_hop.launches == n0 + 1
    assert _close(got, ref, out_t)


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", MESH_KINDS, ids=str)
@pytest.mark.parametrize("case", ["x2", "x6", "misaligned"])
@pytest.mark.parametrize("link_t", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["k7a", "k7a_clover", "k4h"])
@pytest.mark.parametrize("dagger", [False, True])
def test_halo_bf16_pair_and_one_site_on_card(mesh, case, link_t, kernel,
                                             dagger):
    """K7a and K4-halo on bf16 psi_ext: pairs at X = 2 (both x wraps inside
    one pair) and X = 6, and the one-site instance for a base two bytes
    off a four-byte boundary; each within 2^-7 of max |out| of the twin,
    the interior / boundary split equal to the single pass."""
    from mugiq_tpu_torch.kernels.wilson import aligned_pairs, launch_plan
    dev = cuda_device()
    dims = (2 if case == "x2" else 6, 6, 4, 8)      # X, Y, Z, T
    X, Y, Z, T = dims
    lt = {"f32": torch.float32, "bf16": torch.bfloat16}[link_t]
    psi = torch.from_numpy(rand((T, 24, Z, Y * X), 1)).to(dev).bfloat16()
    U = torch.from_numpy(rand((T, 4, 18, Z, Y * X), 2, 0.5)).to(dev).to(lt)
    A = torch.from_numpy(rand((T, 144, Z, Y * X), 3, 0.2)).to(dev).to(lt)
    m = LatticeMesh(mesh, dims, rank=_far_rank(mesh, dims), device=dev)
    ze, ye, Yl, Tl = m.z_ext, m.y_ext, m.local["y"], m.local["t"]
    ext = dict(z=ze, y=ye)
    pe = m.ext_block(psi, t=True, **ext)
    if case == "misaligned":
        pe = _misaligned(pe)
    Ue = m.ext_block(U, t=False, **ext)
    Ute = m.ext_block(torch.roll(U[:, 3], 1, 0), t=False, **ext)
    if kernel == "k4h":
        fn, plain, k = dslash_hop_halo, dslash_hop_halo_plain, (
            pe, Ue, Ute, dagger, Yl, ze, ye)
    else:
        Al = m.local_block(A).contiguous() if kernel == "k7a_clover" else None
        fn, plain, k = wilson_m_halo, wilson_m_halo_plain, (
            pe, Ue, Ute, Al, 0.13, dagger, Yl, ze, ye)
    plan = launch_plan("dslash_hop_halo" if kernel == "k4h" else
                       "wilson_m_halo", 1, X, True, aligned_pairs(pe, Ue, Ute))
    assert plan.pair == (case != "misaligned")
    ref = plain(*k)
    n0 = fn.launches
    got = fn(*k)
    split = torch.full_like(got, float("nan"))
    fn(*k, rows=(1, Tl - 2, 1), out=split)
    fn(*k, rows=(0, 2, Tl - 1), out=split)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 3
    assert _close(got, ref, "bf16")
    assert torch.equal(split, got)
