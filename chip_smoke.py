#!/usr/bin/env python3
"""On-card smoke test of mugiq_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py                 # all phases, one CUDA device
    python3 chip_smoke.py --phases build,parity   # a subset, in this order

Phases (each prints its own lines and raises on failure):
  build     the card (nvidia-smi name and power limit), torch and nvcc
            versions, the kernels' build from the sources in this checkout
            (one nvcc per source, all started together);
  kernels   K1-K3 against their plain PyTorch twins on the card at the
            flagship shapes (32^3x64): max error against a stated
            tolerance, kernel / twin times from CUDA events (median after
            warm-up), and each kernel's least-time bound;
  parity    K6 against its twin at 32^3x64 in every variant (pass 1 with
            and without A_post, pass 2 with and without A_comb, M and M^dag,
            f32 and bf16 links), with times and bounds;
  identity  K6 tied to K1 at 32^3x64: M_pc psi_e equals the even half of
            K1(psi_e, psi_o) with psi_o = A_oo^-1 kappa D_oe psi_e, whose
            odd half vanishes (Wilson and clover, M and M^dag);
  slice     the loop slice at 8^3x16 through the kernels on the card
            against the same slice through the twins on the CPU;
  pc-slice  the even-odd preconditioned eigensolve at 8^3x16, likewise;
  flagship  the flagship 32^3x64 loop through the CLI
            (mugiq_tpu_torch.cli.loop);
  pc-flagship  the flagship 32^3x64 pc eigensolve through the CLI
            (mugiq_tpu_torch.cli.eigensolve --solve-type direct-pc);
  hopdir    K5 against its twin at 32^3x64 for all 8 (mu, sign), M and
            M^dag, f32 and bf16 links, with times and bounds, and K5 tied
            to K1: psi - kappa sum_{mu, sign} K5(psi) = K1(psi) (Wilson);
  mg-slice  the MG-deflated loop at 8^3x16 (2 levels, block 2^4, n_vec 6)
            through the kernels on the card against the same run through
            the twins on the CPU;
  mg-flagship  the MG-deflated 32^3x64 loop through the CLI (the settings
            of scripts/time_mg32.py plus one displacement), held to the
            coarse eigenvalues the JAX package recorded.
Each of the three flagships is a main path: every launch counter is set to
0 just before it and read just after.  The last two lines are
{"kernels": [...]} and {"ok": true, "device": {...}}.  Without CUDA, or
outside a checkout of the repository, it exits nonzero and prints no
result.
"""

import argparse
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

# The flagship invocation of artifacts/flagship32_cli.json, with the gauge
# built in-process by the same generator (numpy default_rng(1) + SU(3) QR).
FLAGSHIP_ARGS = [
    "--dims", "32", "32", "32", "64", "--gauge", "random", "--gauge-seed", "1",
    "--kappa", "0.12", "--eig-nev", "8", "--eig-nkr", "24", "--eig-tol", "1e-5",
    "--eig-max-restarts", "30", "--eig-use-poly-acc", "--eig-poly-deg", "16",
    "--eig-amin", "0.25", "--loop-do-nonlocal", "yes",
    "--displace-entry-string", "+z:1", "--production"]
FLAGSHIP_MOMENTA = "0 0 0\n1 0 0\n0 1 1\n"
MAX_RESIDUAL = 1e-3          # the TPU run of this invocation reached 2.8e-5

# The same lattice, gauge and eigensolver recipe, eigensolving the packed
# even-odd preconditioned MdagM.  The Chebyshev window's lower edge
# belongs to the pc spectrum, not to the loop's 0.25: on this gauge the
# eight lowest pc eigenvalues lie in [0.4429, 0.4439], so 0.5 sits 13%
# above them (PERF.md says how they were measured).
PC_FLAGSHIP_ARGS = [
    "--dims", "32", "32", "32", "64", "--gauge", "random", "--gauge-seed", "1",
    "--kappa", "0.12", "--eig-nev", "8", "--eig-nkr", "24",
    "--eig-tol", "1e-5", "--eig-max-restarts", "30", "--eig-use-poly-acc",
    "--eig-poly-deg", "16", "--eig-amin", "0.5", "--solve-type", "direct-pc",
    "--production"]
PC_SLICE_AMIN = 0.2

# The MG-deflated loop of scripts/time_mg32.py (2 levels, block 4^4 ->
# coarse 8^3x16, 12 null vectors, 8 setup iterations, bf16 links, nEv 8,
# nKr 24, tol 1e-6) with one displacement, so that K3 runs on MG evecs.
MG_FLAGSHIP_ARGS = [
    "--dims", "32", "32", "32", "64", "--gauge", "random", "--gauge-seed", "1",
    "--kappa", "0.12", "--eig-nev", "8", "--eig-nkr", "24", "--eig-tol", "1e-6",
    "--eig-max-restarts", "120", "--mugiq-use-mg", "yes", "--mg-levels", "2",
    "--mg-block-size", "4", "4", "4", "4", "--mg-nvec", "12",
    "--mg-setup-iters", "8", "--link-precision", "bf16",
    "--loop-do-nonlocal", "yes", "--displace-entry-string", "+z:1",
    "--production"]
MG_FLAGSHIP_MOMENTA = "0 0 0\n1 0 0\n"
# the four lowest coarse eigenvalues of that run (artifacts/time_mg32.json,
# "coarse_evals4"): the same gauge, hierarchy recipe and coarse operator
MG_COARSE_EVALS4 = (0.35264265537261963, 0.3527253270149231,
                    0.35273972153663635, 0.35287201404571533)
MG_EVALS_RTOL = 1e-3
MG_MAX_RESIDUAL = 1e-5

# kernel vs twin: max |kernel - twin| / max |twin|.  Both run in f32 with
# the same inputs and differ only in summation order (K1, K6: half-spinor
# vs full projector form, ~100 terms per output; K2: n*3 terms; K3: 3).
TOL = {"wilson_m": 2e-5, "loop_contract": 2e-5, "covariant_displace": 1e-5,
       "parity_hop": 2e-5, "dslash_hop_dir": 2e-5, "identity": 1e-5}

TPU_KERNEL = {
    "wilson_m": "mugiq_tpu/pallas/dslash_kernel.py:395",
    "loop_contract": "mugiq_tpu/pallas/contract_kernel.py:99",
    "covariant_displace": "mugiq_tpu/pallas/contract_kernel.py:192",
    "parity_hop": "mugiq_tpu/pallas/schur_kernel.py:350",
    "dslash_hop_dir": "mugiq_tpu/pallas/dslash_kernel.py:736",
}
SOURCE = {
    "wilson_m": "mugiq_tpu_torch/kernels/csrc/wilson_m.cu",
    "loop_contract": "mugiq_tpu_torch/kernels/csrc/contract.cu",
    "covariant_displace": "mugiq_tpu_torch/kernels/csrc/contract.cu",
    "parity_hop": "mugiq_tpu_torch/kernels/csrc/parity_hop.cu",
    "dslash_hop_dir": "mugiq_tpu_torch/kernels/csrc/hop_dir.cu",
}

# T, Z, Y, X of the kernel-vs-twin phases: the flagships' lattice
KERNEL_SHAPE = (64, 32, 32, 32)

# The least time the card could take (H100 SXM data sheet): HBM 3.35 TB/s;
# float32 outside the tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def say(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2):
    """Median time of fn() in ms from CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    ts.sort()
    return ts[len(ts) // 2]


def bound(nbytes, flops):
    """Least time in ms: each input read once and each output written once
    at the HBM rate, or the f32 operations at the f32 peak, the larger."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(b_ms, f_ms),
            "bound_by": "bytes" if b_ms >= f_ms else "operations"}


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def compare(name, got, ref):
    import torch
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    rel = err / scale
    if not (rel <= TOL[name]):
        raise AssertionError(f"{name}: kernel vs twin rel err {rel:.3e} > "
                             f"{TOL[name]:.0e}")
    return err, rel


def phase_build():
    import torch
    from mugiq_tpu_torch.kernels import build
    say(f"card: {card_line()}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    nv = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                        text=True, check=True).stdout.strip().splitlines()[-1]
    say(f"nvcc: {nv}")
    t0 = time.perf_counter()
    build.build_all()
    say(f"build {', '.join(n + '.cu' for n in build.sources())} (parallel "
        f"nvcc): {time.perf_counter() - t0:.2f} s")
    for name in build.sources():
        build.load(name)
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")


def phase_kernels(dev, stats):
    """Each kernel against its twin on the card at 32^3x64."""
    import torch
    from mugiq_tpu_torch.kernels.contract import (
        covariant_displace, covariant_displace_plain, loop_contract,
        loop_contract_plain)
    from mugiq_tpu_torch.kernels.wilson import (FLOP_PER_SITE, wilson_m,
                                                wilson_m_plain)

    # streaming-copy roofline: 1 GiB read + 1 GiB written per copy
    src = torch.empty(1 << 28, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), 20)
    stats["copy_GBps"] = 2 * src.numel() * 4 / ms / 1e6
    say(f"streaming copy 1 GiB: {ms:.3f} ms, {stats['copy_GBps']:.0f} GB/s "
        f"(read + write)")
    del src, dst

    T, Z, Y, X = KERNEL_SHAPE
    g = torch.Generator(device=dev).manual_seed(0)
    psi = torch.randn((T, 24, Z, Y * X), generator=g, device=dev)
    U = torch.randn((T, 4, 18, Z, Y * X), generator=g, device=dev) * 0.5
    A = torch.randn((T, 144, Z, Y * X), generator=g, device=dev) * 0.2
    kappa = 0.12

    worst = (0.0, 0.0)
    for prec, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        Ul, Al = U.to(dt), A.to(dt)
        for clover in (False, True):
            for dagger in (False, True):
                A144 = Al if clover else None
                ref = wilson_m_plain(psi, Ul, A144, kappa, dagger, Y)
                got = wilson_m(psi, Ul, A144, kappa, dagger, Y)
                err, rel = compare("wilson_m", got, ref)
                worst = max(worst, (rel, err))
                ms = cuda_ms(lambda: wilson_m(psi, Ul, A144, kappa, dagger,
                                              Y), 20)
                pms = cuda_ms(lambda: wilson_m_plain(psi, Ul, A144, kappa,
                                                     dagger, Y), 5, 1)
                vol = T * Z * Y * X
                # least traffic: psi in + out (96 + 96 B), 4 local links
                # (72 words), clover (144 words) per site; clover adds
                # 2 x 6 x 6 complex multiply-adds per site
                moved = nbytes(psi, Ul, A144, got)
                b = bound(moved, (FLOP_PER_SITE + (576 if clover else 0))
                          * vol)
                say(f"K1 wilson_m {prec} clover={int(clover)} "
                    f"dagger={int(dagger)}: rel err {rel:.2e} (abs {err:.2e},"
                    f" tol {TOL['wilson_m']:.0e})  kernel {ms:.3f} ms "
                    f"({FLOP_PER_SITE * vol / ms / 1e6:.0f} GFLOP/s "
                    f"hop-equivalent; bound {b['bound_ms']:.3f} ms by "
                    f"{b['bound_by']}, {b['bound_ms'] / ms:.2f} of it; "
                    f"{moved / (stats['copy_GBps'] * 1e6) / ms:.2f} of copy "
                    f"roofline)  twin {pms:.3f} ms")
                if (prec, clover, dagger) == ("f32", False, False):
                    stats["wilson_m"] = {"ms": ms, "plain_ms": pms,
                                         "library_ms": None, **b}
                del ref, got
    stats["wilson_m"]["max_abs_err"] = worst[1]

    n = 8
    L = torch.randn((n, T, 24, Z, Y * X), generator=g, device=dev)
    R = torch.randn((n, T, 24, Z, Y * X), generator=g, device=dev)
    w = torch.rand((n,), generator=g, device=dev) + 0.5
    ref = loop_contract_plain(L, R, w)
    got = loop_contract(L, R, w)
    err, rel = compare("loop_contract", got, ref)
    ms = cuda_ms(lambda: loop_contract(L, R, w), 20)
    pms = cuda_ms(lambda: loop_contract_plain(L, R, w), 5, 1)
    # 16 spin pairs x 3 colours of complex multiply-adds per site and evec
    b = bound(nbytes(L, R, w, got), n * T * Z * Y * X * 16 * 3 * 8)
    say(f"K2 loop_contract n={n}: rel err {rel:.2e} (abs {err:.2e}, tol "
        f"{TOL['loop_contract']:.0e})  kernel {ms:.3f} ms (bound "
        f"{b['bound_ms']:.3f} ms by {b['bound_by']}, "
        f"{b['bound_ms'] / ms:.2f} of it)  twin {pms:.3f} ms")
    stats["loop_contract"] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                              "library_ms": None, **b}
    del ref, got, R

    worst = (0.0, 0.0)
    for mu in range(4):
        for sgn in (1, -1):
            ref = covariant_displace_plain(L, U, mu, sgn, Y)
            got = covariant_displace(L, U, mu, sgn, Y)
            err, rel = compare("covariant_displace", got, ref)
            worst = max(worst, (rel, err))
            tag = ("+" if sgn > 0 else "-") + "xyzt"[mu]
            say(f"K3 covariant_displace {tag} n={n}: rel err {rel:.2e} "
                f"(abs {err:.2e}, tol {TOL['covariant_displace']:.0e})")
            del ref, got
    out = torch.empty_like(L)
    ms = cuda_ms(lambda: covariant_displace(L, U, 2, 1, Y, out=out), 20)
    pms = cuda_ms(lambda: covariant_displace_plain(L, U, 2, 1, Y), 5, 1)
    # reads the mu = z links only; 4 spins of a 3x3 complex matvec per site
    b = bound(nbytes(L, out) + nbytes(U) // 4, n * T * Z * Y * X * 4 * 72)
    say(f"K3 covariant_displace +z n={n}: kernel {ms:.3f} ms (bound "
        f"{b['bound_ms']:.3f} ms by {b['bound_by']}, "
        f"{b['bound_ms'] / ms:.2f} of it)  twin {pms:.3f} ms")
    stats["covariant_displace"] = {"max_abs_err": worst[1], "ms": ms,
                                   "plain_ms": pms, "library_ms": None, **b}


def phase_slice(dev):
    """The slice at 8^3x16 through the kernels (card) vs the twins (CPU)."""
    import numpy as np
    from mugiq_tpu_torch.io.gauge_io import load_gauge_np
    from mugiq_tpu_torch.lattice import LatticeGeometry
    from mugiq_tpu_torch.params import (EigParam, GaugeParam, InvertParam,
                                        LoopParam)
    from mugiq_tpu_torch.production import compute_loop_production

    geom = LatticeGeometry((8, 8, 8, 16))
    U = load_gauge_np("weak:0.5", geom, seed=1)
    gp = GaugeParam(dims=geom.dims)
    ip = InvertParam(kappa=0.13)
    # n_ev = 4 ends at a gap of the spectrum (0.04987 | 0.05020)
    ep = EigParam(n_ev=4, n_kr=24, tol=1e-6, max_restarts=100,
                  use_poly_acc=True, poly_deg=12, a_min=0.15)
    lp = LoopParam(momenta=[(0, 0, 0), (1, 0, 0), (0, 1, 1)],
                   do_nonlocal=True, disp_entries=["+z:1,2", "-t:1"])
    out = {}
    for name, d in (("kernels", dev), ("twins", "cpu")):
        t0 = time.perf_counter()
        out[name] = compute_loop_production(U, gp, ip, ep, lp, device=d)
        r = out[name]
        say(f"slice 8^3x16 via {name} on {d}: {time.perf_counter() - t0:.2f}"
            f" s, converged={r.converged} restarts={r.n_restarts} "
            f"max resid {max(r.resids):.2e}")
        if not r.converged:
            raise AssertionError(f"slice via {name} did not converge")
    a, b = out["kernels"], out["twins"]
    # evals: both converged to tol 1e-6 relative
    ev_rel = float(np.max(np.abs(a.evals - b.evals) / b.evals))
    # data_mom: n_ev sits at a spectral gap, so the deflation subspace is
    # well defined; its error is ~ resid / gap
    dm = float(np.max(np.abs(a.data_mom - b.data_mom))
               / np.max(np.abs(b.data_mom)))
    say(f"slice kernels vs twins: evals rel {ev_rel:.2e} (tol 1e-5), "
        f"data_mom rel {dm:.2e} (tol 1e-3)")
    if not (ev_rel < 1e-5 and dm < 1e-3):
        raise AssertionError("slice through kernels disagrees with twins")


def phase_parity(dev, stats):
    """K6 against its twin on the card at 32^3x64, every variant."""
    import torch
    from mugiq_tpu_torch.kernels.parity import parity_hop, parity_hop_plain
    from mugiq_tpu_torch.kernels.wilson import FLOP_PER_SITE

    T, Z, Y, X = KERNEL_SHAPE
    Xh = X // 2
    sites = T * Z * Y * Xh
    g = torch.Generator(device=dev).manual_seed(1)
    psi = torch.randn((T, 24, Z, Y * Xh), generator=g, device=dev)
    pe = torch.randn((T, 24, Z, Y * Xh), generator=g, device=dev)
    Uo = torch.randn((T, 4, 18, Z, Y * Xh), generator=g, device=dev) * 0.5
    Ui = torch.randn((T, 4, 18, Z, Y * Xh), generator=g, device=dev) * 0.5
    A = torch.randn((T, 144, Z, Y * Xh), generator=g, device=dev) * 0.2
    k2 = 0.12 ** 2
    worst = (0.0, 0.0)
    for prec, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        Uol, Uil, Al = Uo.to(dt), Ui.to(dt), A.to(dt)
        variants = (("pass1", {}), ("pass1+A_post", dict(A_post=Al)),
                    ("pass2", dict(kappa2=k2, psi_out=pe)),
                    ("pass2+A_comb", dict(kappa2=k2, psi_out=pe, A_comb=Al)))
        for tag, kw in variants:
            for dagger in (False, True):
                # pass 1 writes the odd parity, pass 2 the even one
                po = 1 if tag.startswith("pass1") else 0
                ref = parity_hop_plain(psi, Uol, Uil, Y, po, dagger, **kw)
                got = parity_hop(psi, Uol, Uil, Y, po, dagger, **kw)
                err, rel = compare("parity_hop", got, ref)
                worst = max(worst, (rel, err))
                del ref
                out = torch.empty_like(psi)
                ms = cuda_ms(lambda: parity_hop(psi, Uol, Uil, Y, po, dagger,
                                                out=out, **kw), 20)
                pms = cuda_ms(lambda: parity_hop_plain(psi, Uol, Uil, Y, po,
                                                       dagger, **kw), 3, 1)
                clover = "A_post" in kw or "A_comb" in kw
                moved = nbytes(psi, Uol, Uil, got, kw.get("psi_out"),
                               kw.get("A_post"), kw.get("A_comb"))
                b = bound(moved, (FLOP_PER_SITE + (576 if clover else 0))
                          * sites)
                say(f"K6 parity_hop {prec} {tag} dagger={int(dagger)}: "
                    f"rel err {rel:.2e} (abs {err:.2e}, tol "
                    f"{TOL['parity_hop']:.0e})  kernel {ms:.3f} ms (bound "
                    f"{b['bound_ms']:.3f} ms by {b['bound_by']}, "
                    f"{b['bound_ms'] / ms:.2f} of it; "
                    f"{moved / (stats['copy_GBps'] * 1e6) / ms:.2f} of copy "
                    f"roofline)  twin {pms:.3f} ms")
                if (prec, tag, dagger) == ("f32", "pass1", False):
                    stats["parity_hop"] = {"ms": ms, "plain_ms": pms,
                                           "library_ms": None, **b}
                del got, out
                torch.cuda.empty_cache()
    stats["parity_hop"]["max_abs_err"] = worst[1]


def phase_identity(dev):
    """K6 tied to K1 at 32^3x64: two independent codes, one operator."""
    import torch
    from mugiq_tpu_torch.dirac_kernel import WilsonDiracKernel
    from mugiq_tpu_torch.kernels.wilson import clover_apply_plain
    from mugiq_tpu_torch.schur_kernel import (SchurDiracKernelPacked,
                                              pack_parity, unpack_parities)

    T, Z, Y, X = KERNEL_SHAPE
    kappa = 0.12
    g = torch.Generator(device=dev).manual_seed(2)
    U = torch.randn((T, 4, 18, Z, Y * X), generator=g, device=dev) * 0.5
    # invertible chiral blocks: 1 + 0.1 * noise (the inverse is taken on
    # the host by SchurDiracKernelPacked)
    blocks = torch.randn((T, 2, 6, 6, 2, Z, Y * X), generator=g,
                         device=dev) * 0.1
    blocks[:, :, range(6), range(6), 0] += 1.0
    pe = None
    for clover in (False, True):
        A = blocks if clover else None
        full = WilsonDiracKernel(U, kappa, Y, A_blocks=A)
        pc = SchurDiracKernelPacked(U, kappa, Y, A_blocks=A)
        if pe is None:
            pe = torch.randn(pc.field_shape, generator=g, device=dev)
        for dagger in (False, True):
            k1 = full.Mdag if dagger else full.M
            # the odd half of K1(psi_e, 0) is -kappa D_oe psi_e
            psi_o = -pack_parity(k1(unpack_parities(pe, torch.zeros_like(pe),
                                                    Y)), Y, 1)
            if clover:
                psi_o = clover_apply_plain(pc.Ainv_o, psi_o)
            r = k1(unpack_parities(pe, psi_o, Y))
            mpc = (pc.Mdag if dagger else pc.M)(pe)
            torch.cuda.synchronize()
            scale = float(mpc.abs().max())
            even = float((pack_parity(r, Y, 0) - mpc).abs().max()) / scale
            odd = float(pack_parity(r, Y, 1).abs().max()) / scale
            say(f"identity K6 vs K1 clover={int(clover)} dagger={int(dagger)}"
                f": even half rel {even:.2e}, odd half rel {odd:.2e} (tol "
                f"{TOL['identity']:.0e})")
            if not (even <= TOL["identity"] and odd <= TOL["identity"]):
                raise AssertionError("K6 disagrees with K1")
            del psi_o, r, mpc
        del full, pc
        torch.cuda.empty_cache()


def phase_pc_slice(dev):
    """The pc eigensolve at 8^3x16 through K6 (card) vs its twin (CPU)."""
    import numpy as np
    from mugiq_tpu_torch.io.gauge_io import load_gauge_np
    from mugiq_tpu_torch.lattice import LatticeGeometry
    from mugiq_tpu_torch.params import EigParam, GaugeParam, InvertParam
    from mugiq_tpu_torch.production import compute_evecs_production

    geom = LatticeGeometry((8, 8, 8, 16))
    U = load_gauge_np("weak:0.5", geom, seed=1)
    gp = GaugeParam(dims=geom.dims)
    ip = InvertParam(kappa=0.13)
    # the pc spectrum starts 0.16193 0.16233 0.16259 0.16273 | 0.16374
    ep = EigParam(n_ev=4, n_kr=24, tol=1e-6, max_restarts=100,
                  use_poly_acc=True, poly_deg=12, a_min=PC_SLICE_AMIN)
    out = {}
    for name, d in (("kernels", dev), ("twins", "cpu")):
        t0 = time.perf_counter()
        res, evals, _, resids = compute_evecs_production(
            U, gp, ip, ep, even_odd=True, device=d)
        out[name] = evals
        say(f"pc slice 8^3x16 via {name} on {d}: "
            f"{time.perf_counter() - t0:.2f} s, converged={res.converged} "
            f"restarts={res.n_restarts} max resid {max(resids):.2e}")
        if not res.converged:
            raise AssertionError(f"pc slice via {name} did not converge")
    # both converged to tol 1e-6 relative
    ev_rel = float(np.max(np.abs(out["kernels"] - out["twins"])
                          / out["twins"]))
    say(f"pc slice kernels vs twins: evals rel {ev_rel:.2e} (tol 1e-5)")
    if not ev_rel < 1e-5:
        raise AssertionError("pc slice through the kernels disagrees with "
                             "the twins")


def run_main_path(name, run, argv, counters):
    """Drive one main path through its CLI's run(argv) with every launch
    counter set to 0 just before and read just after; returns (result,
    wall s, PROFILE phases, launches)."""
    from mugiq_tpu_torch.utils import reset_profile

    msgs = []

    class Keep(logging.Handler):
        def emit(self, record):
            msgs.append(record.getMessage())

    handler = Keep()
    logger = logging.getLogger("mugiq_tpu_torch")
    logger.addHandler(handler)
    try:
        reset_profile()
        for k in counters:
            k.launches = 0
        t0 = time.perf_counter()
        res = run(argv)
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in counters}
    finally:
        logger.removeHandler(handler)
    phases = {k: float(v) for k, v in re.findall(
        r"PROFILE\s+([\w-]+):\s+([0-9.]+)s", "\n".join(msgs))}
    say(f"{name}: wall {wall:.2f} s, phases {json.dumps(phases)}")
    say(f"{name}: launches {json.dumps(launches)}")
    return res, wall, phases, launches


def check_eigs(name, evals, resids, sigma):
    for i, (lam, r, s) in enumerate(zip(evals, resids, sigma)):
        say(f"{name}: eval[{i}] {lam:+.10e} resid {r:.3e} sigma {s:.8e}")
    import numpy as np
    if not all(np.isfinite(np.asarray(x)).all()
               for x in (evals, resids, sigma)):
        raise AssertionError(f"{name}: non-finite eigenpairs")
    if max(resids) >= MAX_RESIDUAL:
        raise AssertionError(f"{name} max residual {max(resids):.3e} >= "
                             f"{MAX_RESIDUAL}")


def phase_flagship(counters):
    import numpy as np
    from mugiq_tpu_torch.cli import loop as cli_loop

    have_h5 = True
    try:
        import h5py  # noqa: F401
    except ImportError:
        have_h5 = False
    tmp = tempfile.mkdtemp(prefix="mugiq_smoke_",
                           dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        mom = os.path.join(tmp, "moms.txt")
        with open(mom, "w") as f:
            f.write(FLAGSHIP_MOMENTA)
        h5 = os.path.join(tmp, "loops32.h5")
        argv = FLAGSHIP_ARGS + ["--momenta-filename", mom]
        if have_h5:
            argv += ["--loop-write-mom-space", "yes",
                     "--loop-mom-space-filename", h5]
        else:
            say("flagship: h5py is not installed here; the HDF5 write is "
                "skipped and data_mom is checked in memory")
        say("flagship CLI: python -m mugiq_tpu_torch.cli.loop "
            + " ".join(argv))
        res, _, _, launches = run_main_path("flagship", cli_loop.run, argv,
                                            counters)
        if have_h5:
            import h5py
            with h5py.File(h5, "r") as f:
                d = f["mom_+1_+0_+0/disp_+z_1/g5/loop"][()]
            if d.shape != (64, 2) or not np.isfinite(d).all():
                raise AssertionError(f"HDF5 loop data bad: {d.shape}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    say(f"flagship: converged={res.converged} restarts={res.n_restarts}")
    check_eigs("flagship", res.evals, res.resids, res.sigma)
    if res.data_mom.shape != (3, 2, 16, 64) or not np.isfinite(
            res.data_mom).all():
        raise AssertionError(f"flagship data_mom: shape {res.data_mom.shape}"
                             f" or not finite")
    for name in ("wilson_m", "loop_contract", "covariant_displace"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"flagship run")
    return launches


def phase_pc_flagship(counters):
    from mugiq_tpu_torch.cli import eigensolve as cli_eig

    argv = PC_FLAGSHIP_ARGS
    say("pc flagship CLI: python -m mugiq_tpu_torch.cli.eigensolve "
        + " ".join(argv))
    (res, evals, sigma, resids), _, _, launches = run_main_path(
        "pc flagship", cli_eig.run, argv, counters)
    say(f"pc flagship: converged={res.converged} restarts={res.n_restarts} "
        f"evecs {tuple(res.evecs.shape)}")
    check_eigs("pc flagship", evals, resids, sigma)
    if tuple(res.evecs.shape) != (8, 64, 24, 32, 512):
        raise AssertionError(f"pc flagship evecs shape {res.evecs.shape}")
    if launches["parity_hop"] <= 0:
        raise AssertionError("K6 was not launched by the pc flagship run")
    if launches["wilson_m"] != 0:
        raise AssertionError("the pc path launched the full operator K1")
    return launches


def phase_hopdir(dev, stats):
    """K5 against its twin on the card at 32^3x64, every variant, and the
    eight directed hops tied to K1."""
    import torch
    from mugiq_tpu_torch.kernels.hop_dir import (FLOP_PER_SITE,
                                                 dslash_hop_dir,
                                                 dslash_hop_dir_plain)
    from mugiq_tpu_torch.kernels.wilson import wilson_m

    T, Z, Y, X = KERNEL_SHAPE
    vol = T * Z * Y * X
    g = torch.Generator(device=dev).manual_seed(3)
    psi = torch.randn((T, 24, Z, Y * X), generator=g, device=dev)
    U = torch.randn((T, 4, 18, Z, Y * X), generator=g, device=dev) * 0.5
    out = torch.empty_like(psi)
    worst = (0.0, 0.0)
    for prec, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        Ul = U.to(dt)
        for dagger in (False, True):
            for mu in range(4):
                for sgn in (1, -1):
                    ref = dslash_hop_dir_plain(psi, Ul, mu, sgn, dagger, Y)
                    got = dslash_hop_dir(psi, Ul, mu, sgn, dagger, Y)
                    err, rel = compare("dslash_hop_dir", got, ref)
                    worst = max(worst, (rel, err))
                    del ref, got
                    ms = cuda_ms(lambda: dslash_hop_dir(
                        psi, Ul, mu, sgn, dagger, Y, out=out), 20)
                    pms = cuda_ms(lambda: dslash_hop_dir_plain(
                        psi, Ul, mu, sgn, dagger, Y), 3, 1)
                    # least traffic: the neighbour spinor, the one link
                    # field U_mu, the output
                    moved = nbytes(psi, out) + nbytes(Ul) // 4
                    b = bound(moved, FLOP_PER_SITE * vol)
                    tag = ("+" if sgn > 0 else "-") + "xyzt"[mu]
                    say(f"K5 dslash_hop_dir {prec} {tag} dagger={int(dagger)}"
                        f": rel err {rel:.2e} (abs {err:.2e}, tol "
                        f"{TOL['dslash_hop_dir']:.0e})  kernel {ms:.3f} ms "
                        f"(bound {b['bound_ms']:.3f} ms by {b['bound_by']}, "
                        f"{b['bound_ms'] / ms:.2f} of it; "
                        f"{moved / (stats['copy_GBps'] * 1e6) / ms:.2f} of "
                        f"copy roofline)  twin {pms:.3f} ms")
                    if (prec, dagger, mu, sgn) == ("f32", False, 0, 1):
                        stats["dslash_hop_dir"] = {
                            "ms": ms, "plain_ms": pms, "library_ms": None,
                            **b}
    stats["dslash_hop_dir"]["max_abs_err"] = worst[1]

    kappa = 0.12
    for prec, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        Ul = U.to(dt)
        for dagger in (False, True):
            acc = psi.clone()
            for mu in range(4):
                for sgn in (1, -1):
                    acc -= kappa * dslash_hop_dir(psi, Ul, mu, sgn, dagger,
                                                  Y, out=out)
            k1 = wilson_m(psi, Ul, None, kappa, dagger, Y)
            torch.cuda.synchronize()
            rel = float((acc - k1).abs().max()) / float(k1.abs().max())
            say(f"identity K5 vs K1 {prec} dagger={int(dagger)}: rel "
                f"{rel:.2e} (tol {TOL['identity']:.0e})")
            if not rel <= TOL["identity"]:
                raise AssertionError("the eight K5 hops disagree with K1")
            del acc, k1


def phase_mg_slice(dev):
    """The MG-deflated loop at 8^3x16 through the kernels (card) vs the
    twins (CPU)."""
    import numpy as np
    from mugiq_tpu_torch.io.gauge_io import load_gauge_np
    from mugiq_tpu_torch.lattice import LatticeGeometry
    from mugiq_tpu_torch.params import (EigParam, GaugeParam, InvertParam,
                                        LoopParam, MGParam)
    from mugiq_tpu_torch.production import compute_loop_production

    geom = LatticeGeometry((8, 8, 8, 16))
    U = load_gauge_np("weak:0.3", geom, seed=1)
    gp = GaugeParam(dims=geom.dims)
    ip = InvertParam(kappa=0.13)
    # the coarse MdagM starts 0.15248 0.15351 0.15482 0.15540 | 0.15919:
    # n_ev = 4 ends at a 2.4% gap
    ep = EigParam(n_ev=4, n_kr=24, tol=1e-6, max_restarts=100)
    lp = LoopParam(momenta=[(0, 0, 0), (1, 0, 0)], do_nonlocal=True,
                   disp_entries=["+z:1,2"])
    mg = MGParam(n_level=2, geo_block_size=[(2, 2, 2, 2)], n_vec=[6],
                 setup_iters=8)
    out = {}
    for name, d in (("kernels", dev), ("twins", "cpu")):
        t0 = time.perf_counter()
        out[name] = compute_loop_production(U, gp, ip, ep, lp, use_mg=True,
                                            mg=mg, device=d)
        r = out[name]
        say(f"mg slice 8^3x16 via {name} on {d}: "
            f"{time.perf_counter() - t0:.2f} s, converged={r.converged} "
            f"restarts={r.n_restarts} max resid {max(r.resids):.2e}")
        if not r.converged:
            raise AssertionError(f"mg slice via {name} did not converge")
    a, b = out["kernels"], out["twins"]
    ev_rel = float(np.max(np.abs(a.evals - b.evals) / b.evals))
    dm = float(np.max(np.abs(a.data_mom - b.data_mom))
               / np.max(np.abs(b.data_mom)))
    say(f"mg slice kernels vs twins: coarse evals rel {ev_rel:.2e} (tol "
        f"1e-5), data_mom rel {dm:.2e} (tol 1e-3)")
    if not (ev_rel < 1e-5 and dm < 1e-3):
        raise AssertionError("mg slice through kernels disagrees with twins")


def phase_mg_flagship(counters):
    import numpy as np
    from mugiq_tpu_torch.cli import loop as cli_loop

    tmp = tempfile.mkdtemp(prefix="mugiq_smoke_",
                           dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        mom = os.path.join(tmp, "moms.txt")
        with open(mom, "w") as f:
            f.write(MG_FLAGSHIP_MOMENTA)
        argv = MG_FLAGSHIP_ARGS + ["--momenta-filename", mom]
        say("mg flagship CLI: python -m mugiq_tpu_torch.cli.loop "
            + " ".join(argv))
        res, _, _, launches = run_main_path("mg flagship", cli_loop.run,
                                            argv, counters)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"mg flagship: converged={res.converged} restarts={res.n_restarts}")
    for i, (lam, r) in enumerate(zip(res.evals, res.resids)):
        say(f"mg flagship: coarse eval[{i}] {lam:+.10e} resid {r:.3e}")
    if not res.converged or not max(res.resids) <= MG_MAX_RESIDUAL:
        raise AssertionError(f"mg flagship: converged={res.converged}, max "
                             f"coarse residual {max(res.resids):.3e} (limit "
                             f"{MG_MAX_RESIDUAL})")
    rel = np.abs(res.evals[:4] - np.asarray(MG_COARSE_EVALS4)) \
        / np.asarray(MG_COARSE_EVALS4)
    say(f"mg flagship: four lowest coarse evals vs the JAX record: rel "
        f"{' '.join(f'{x:.2e}' for x in rel)} (tol {MG_EVALS_RTOL:.0e})")
    if not np.all(rel <= MG_EVALS_RTOL):
        raise AssertionError("mg flagship coarse eigenvalues disagree with "
                             "the JAX record")
    if res.data_mom.shape != (2, 2, 16, 64) or not np.isfinite(
            res.data_mom).all():
        raise AssertionError(f"mg flagship data_mom: shape "
                             f"{res.data_mom.shape} or not finite")
    for name in ("wilson_m", "loop_contract", "covariant_displace",
                 "dslash_hop_dir"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the mg "
                                 f"flagship run")
    return launches


PHASES = ("build", "kernels", "parity", "identity", "slice", "pc-slice",
          "flagship", "pc-flagship", "hopdir", "mg-slice", "mg-flagship")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    phases = ap.parse_args(argv).phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mugiq_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(mugiq_tpu_torch/ not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    import mugiq_tpu_torch  # noqa: F401  (pins full-f32 GEMMs)
    from mugiq_tpu_torch.kernels.contract import (covariant_displace,
                                                  loop_contract)
    from mugiq_tpu_torch.kernels.hop_dir import dslash_hop_dir
    from mugiq_tpu_torch.kernels.parity import parity_hop
    from mugiq_tpu_torch.kernels.wilson import wilson_m

    counters = [wilson_m, loop_contract, covariant_displace, parity_hop,
                dslash_hop_dir]
    dev = torch.device("cuda")
    stats = {}
    launches = {}
    t0 = time.perf_counter()
    for phase in phases:
        tp = time.perf_counter()
        if phase == "build":
            phase_build()
        elif phase == "kernels":
            phase_kernels(dev, stats)
        elif phase == "parity":
            if "copy_GBps" not in stats:
                phase_kernels(dev, stats)
            phase_parity(dev, stats)
        elif phase == "identity":
            phase_identity(dev)
        elif phase == "slice":
            phase_slice(dev)
        elif phase == "pc-slice":
            phase_pc_slice(dev)
        elif phase == "flagship":
            got = phase_flagship(counters)
            for k in ("wilson_m", "loop_contract", "covariant_displace"):
                launches[k] = got[k]
        elif phase == "pc-flagship":
            launches["parity_hop"] = phase_pc_flagship(counters)["parity_hop"]
        elif phase == "hopdir":
            if "copy_GBps" not in stats:
                phase_kernels(dev, stats)
            phase_hopdir(dev, stats)
        elif phase == "mg-slice":
            phase_mg_slice(dev)
        else:
            launches["dslash_hop_dir"] = phase_mg_flagship(
                counters)["dslash_hop_dir"]
        torch.cuda.empty_cache()
        say(f"phase {phase}: {time.perf_counter() - tp:.1f} s")
    say(f"chip_smoke: phases {','.join(phases)} passed in "
        f"{time.perf_counter() - t0:.1f} s")
    say(card_line())
    say(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE[k],
         "replaces": TPU_KERNEL[k], "launches": launches[k], **stats[k]}
        for k in TPU_KERNEL if k in stats and k in launches]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
