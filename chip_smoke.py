#!/usr/bin/env python3
"""On-card smoke test of mugiq_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py                 # all phases, one CUDA device
    python3 chip_smoke.py --phases build,parity   # a subset, in this order

Phases (each prints its own lines and raises on failure):
  build     the card (nvidia-smi name and power limit), torch and nvcc
            versions, the kernels' build from the sources in this checkout
            (one nvcc per source, at most one per core at once, the longest
            first; each source's seconds), and the registers and spills of
            every instance of the stencils' kernels (K1, K4-K7b);
  kernels   K1-K3 against their plain PyTorch twins on the card at the
            flagship shapes (32^3x64): max error against a stated
            tolerance, kernel / twin times from CUDA events (median after
            warm-up), each kernel's least-time bound, and for K2 the one
            torch.einsum that computes its function;
  parity    K6 against its twin at 32^3x64 in every variant (pass 1 with
            and without A_post, pass 2 with and without A_comb, M and M^dag,
            f32 and bf16 links), with times and bounds;
  bf16      K1 and K6 with bf16 spinors (bf16 in, bf16 out; f32 and bf16
            links, both daggers, Wilson and clover, every K6 pass) against
            their twins at 32^3x64 within one bf16 ulp of max |out|;
            batched launches (b = 2, 3, 4, f32 and bf16 spinors) against
            single launches, exactly; times and bounds of every form;
  identity  K6 tied to K1 at 32^3x64: M_pc psi_e equals the even half of
            K1(psi_e, psi_o) with psi_o = A_oo^-1 kappa D_oe psi_e, whose
            odd half vanishes (Wilson and clover, M and M^dag);
  slice     the loop slice at 8x4x4x8 (TWIN_DIMS) through the kernels on
            the card against the same slice through the twins on the CPU;
  pc-slice  the even-odd preconditioned eigensolve at 8x4x4x8, likewise;
  bf16-restart  the JAX package's TPU restart bench (bench.py
            _bench_eig32_restart: 32^3x64, random-normal links, MdagM, nKr
            24, nEv 8) through the port: warm s/restart with bf16 links and
            a bf16 basis, and with f32 links and an f32 basis;
  bf16-slice  the bf16-basis eigensolve at 8x4x4x8 (full and pc operator)
            through the kernels on the card against the twins on the CPU,
            and against the f32 basis;
  block-slice  block Lanczos (b = 4) of the pc eigensolve at 8x4x4x8
            through K6's batched launch against the twins and b = 1;
  arnoldi-slice  the Krylov-Schur Arnoldi of M and M^dag at 8x4x4x8
            (compute_evecs_production; no CLI reaches it) through the
            kernels against the twins;
  flagship  the flagship 32^3x64 loop through the CLI
            (mugiq_tpu_torch.cli.loop);
  bf16-flagship, block-flagship  the same invocation with
            --basis-precision bf16, and with --eig-block-size 4, held to
            the f32 flagship's eigenvalues (3e-2, residual < 0.1; 1e-4,
            residual < 1e-3);
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
            coarse eigenvalues the JAX package recorded;
  mg-mesh   the same invocation over --mesh 2 1 (two gloo ranks sharing
            the card: null vectors smoothed on K7a, Galerkin probes on K5
            across the rank edge (first held, every (mu, sign) on each
            rank's block, to K5's twin on the global field at
            TOL['dslash_hop_dir'], eight K5 launches and no other), the
            coarse operator gathered and eigensolved on both ranks, the
            sharded measurement on K2 and K3), each rank held to
            mg-flagship's checks and to its run (coarse evals 1e-4,
            data_mom 1e-3 of max, the same restarts on both ranks), K7a,
            K5, K2 and K3 launched, K1 not; each rank's wall, mg-* phases,
            launches and halo bytes and host seconds;
  coarse-loop  the coarse-space ultra-local loop at 32^3x64 through the
            loop CLI's API path (no --production, --prec single, the MG
            flagship's lattice, gauge, kappa, eigensolver and hierarchy,
            --mugiq-compute-coarse yes --loop-coarse-ulocal yes): coarse
            residual <= 1e-5, the loop [P, 16, T] finite and equal to its
            fine factorized form from the prolongated eigenvectors (on the
            card, complex128) within 1e-4 of max |L|, every field on the
            card; the phase's and the restriction's seconds;
  stoch-flagship  the deflated stochastic trace at 32^3x64 (the recipe of
            the JAX package's scripts/stoch32.py on the flagship gauge:
            an nEv 8 MdagM eigensolve, 4 Z4 noises, CG tol 1e-5,
            deflated and plain; stochastic_production, CG on M^dag M
            through K1, contractions through K2): each noise's CG
            iterations and residual (<= 1e-5), the deflation build and
            probe seconds, K1's and K2's launches (> 0), the variance
            over the noises of the volume-summed Gamma = 1 and gamma_5
            traces, deflated against plain; then the same trace at
            8^3x16 through the kernels against the twins on the CPU (the
            card's eigenvectors), within 1e-5 of max |data|;
  hop       K4 (the bare hop D psi) against its twin at 32^3x64 in all 16
            variants (spinor, links and output f32 or bf16, D and D^dag;
            bf16 spinors two sites a thread), and its one-site bf16
            instance (a misaligned base) against its twin and timed beside
            the pair form;
            K4 tied to the eight K5 hops and to K1; the masked even-even
            preconditioned operator (dirac_kernel.SchurDiracKernel, two K4
            hops per application) tied to K6's packed M_pc and timed
            beside it, as a main path of K4; the headline hop, a chain of
            K4 applications timed as bench.py times the TPU kernel
            (16^3x32 f32, 32^3x64 f32 and all-bf16);
  halo      K7a, K4-halo and K7b (the halo-extended Wilson operator, bare
            hop and parity hop of one rank's block) against their twins at
            the 32^3x64 shapes of rank 0 of a --mesh 2 1 and a --mesh 2 2 2
            grid, every variant, with times, bounds and the interior /
            boundary launch times; every rank's block concatenated tied to
            K1, K4 and K6 on the global field; then their bf16-spinor
            forms (bf16 in and out; f32 and bf16 links; every variant) at
            the 2 1 rank-0 block against their twins within 2^-7 of max
            |out|, the split bit for bit, timed with bounds, and both
            ranks' blocks tied to the bf16-spinor K1, K4 and K6; K7a's and
            K4-halo's bf16 pairs of the z and y halo forms (rank 0 of 2 2
            and 2 2 2) against their twins, and their one-site bf16
            instance (a misaligned base) likewise, timed beside the pairs;
  mesh-slice  the 8^3x16 loop over --mesh 2 2 2 (8 ranks on the card,
            gloo) and the pc eigensolve (f32 and bf16 basis), its block
            Lanczos (b = 4), the Arnoldi of M and the loop with keep_pos
            over --mesh 2 1, held to the same runs on one device (a bf16
            basis: evals 1e-3; keep_pos: the global data_pos 1e-3 of
            max); the pc run's evecs through the per-rank npz files
            (save_evecs_sharded / load_evecs_sharded) bit for bit; the
            sharded bare hop (ShardedWilsonKernel _hop / _hop_dag,
            K4-halo) on f32 and bf16 fields over 2 1 and 2 2 2, each rank
            held to K4's twin and to K4 on the global field;
  mesh-flagship  the 32^3x64 loop flagship over --mesh 1 1 (one rank,
            NCCL) and --mesh 2 1 (two ranks: gloo with host-staged halos
            on a one-card machine, NCCL too where there are two cards),
            held to the single-device flagship; before the 2 1 loop the
            sharded bare hop of the flagship gauge, as in mesh-slice; then
            the flagship with --link-precision bf16 --basis-precision bf16,
            capped at BF16_MESH_RESTARTS restarts, on one device and over
            the same meshes, in the f32 run's launch (the bf16 Krylov
            basis under --mesh: bf16 spinors through the exchange and
            K7a), each rank held to the
            one-device run (evals 1e-3, residual < 0.1, data_mom finite)
            and to the f32 flagship (evals 3e-2);
  api-slice  the API path (the CLIs without --production, complex
            fields, plain PyTorch: no TPU kernel is on it) at 8^3x16 on
            the card against the same runs on the CPU (in this process,
            after the card's, every host core): the loop in
            complex128 (evals 1e-10, data_mom 1e-8 normwise) and complex64
            (1e-5, 1e-4), and the MG-coarse eigensolve in complex128
            (coarse evals 1e-10) with the coarse-space ultra-local loop
            of its eigenpairs (mg.coarse_loop, 1e-10 of max |L|);
  api-fp64  the error budget of scripts/error_budget16.py on the card:
            the fp64 API loop at 16^3x32 converged (max residual <= 1e-8),
            the f32 production loop (< 1e-3; evals within 1e-5 of fp64),
            and the correlators' relative error (normwise, median, max),
            with the API path's M and M^dag M times (CUDA events),
            printed as {"error_budget16": {...}}.
The ranks of a sharded run are processes of ``python -m
torch.distributed.run`` running this script with --mesh-worker.
Each flagship is a main path: every launch counter is set to 0 just
before it and read just after (in every rank for the sharded ones).  K4
and K4-halo have no CLI path (in the JAX package neither): their main
paths are the masked operator's M^dag M applications in `hop` and the
sharded bare hop of the 32^3x64 `--mesh 2 1` launch in
`mesh-flagship` (in `mesh-slice` when that phase runs without it),
counted the same way.  The bf16-spinor and batched forms of K1 and K6
report their launches from bf16-flagship (K1 bf16), bf16-slice (K6
bf16), block-flagship (K1 batched) and block-slice (K6 batched), as
fields of their kernel's entry; the halo kernels' bf16-spinor forms
(each wrapper counts them apart too, as bf16_launches) from the bf16
`--mesh 1 1` flagship (K7a, all-bf16), the bf16-basis pc run of
mesh-slice (K7b, f32 links) and the sharded hop's bf16 field
(K4-halo); K1 and K2 also report their launches in the stochastic trace
of stoch-flagship (stoch_launches).  The GPU machine has no h5py: the
position-space and momentum-space files are written only where h5py is
installed (the CPU tests hold the position-space files to the JAX
package's).  The last two lines are {"kernels": [...]} and {"ok": true,
"device": {...}}.  Without CUDA, or outside a checkout of the
repository, it exits nonzero and prints no result.
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
# built by the same generator (numpy default_rng(1) + SU(3) QR): once per
# run of this script, handed to every 32^3x64 CLI run as an exact ILDG copy
# (with_flagship_gauge).
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

# The lattice of the slices whose CPU twins run in this script (slice,
# pc-slice, bf16-slice, block-slice, arnoldi-slice): 8x4x4x8, a quarter of
# 8^3x16's sites, so that the twins' CPU time is about a fifth of it.
# weak:0.5, seed 1, kappa 0.13: M^dag M starts 0.05132 0.05152 0.05211
# 0.05228 | 0.05409, the pc M^dag M 0.16735 0.16789 0.16985 0.17036 |
# 0.17538 (the API path in complex128 converged to 1e-9), so n_ev = 4
# ends at a 3.5% and a 2.9% gap; the Chebyshev windows start 19% and 17%
# above the fourth eigenvalue.
TWIN_DIMS = (8, 4, 4, 8)
TWIN_AMIN = 0.062
TWIN_PC_AMIN = 0.2

# The block-Lanczos flagship: b = 4 at nKr 24 keeps 16 vectors and adds two
# block steps a restart, so it needs some 4-5x the restarts of b = 1, in the
# JAX package as in the port (on the CPU, 4x4x2x4 MdagM: 141 and 116
# against 23); at the flagship's cap of 30 it stops short of tol (max
# residual 6.0e-3 on the H100, PERF.md), so this run raises the cap only.
BLOCK_FLAGSHIP_FLAGS = ["--eig-block-size", "4", "--eig-max-restarts", "200"]

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


def drop_flags(args, flags):
    """args without the given flags, each with its number of values."""
    out, i = [], 0
    while i < len(args):
        if args[i] in flags:
            i += 1 + flags[args[i]]
        else:
            out.append(args[i])
            i += 1
    return out


# The coarse-space ultra-local loop (coarse-loop): the MG flagship's
# lattice, gauge, kappa, eigensolver and hierarchy on the API path (no
# --production; complex64), without bf16 links and the displacement, the
# coarse eigenvectors' loop assembled by mg.coarse_loop, at
# MG_FLAGSHIP_MOMENTA; held to its fine factorized form within
# COARSE_LOOP_TOL of max |L|
COARSE_LOOP_ARGS = drop_flags(MG_FLAGSHIP_ARGS, {
    "--production": 0, "--link-precision": 1, "--loop-do-nonlocal": 1,
    "--displace-entry-string": 1}) + [
    "--prec", "single", "--mugiq-compute-coarse", "yes",
    "--loop-coarse-ulocal", "yes"]
COARSE_LOOP_TOL = 1e-4

# The deflated stochastic trace (stoch-flagship): the recipe of the JAX
# package's scripts/stoch32.py, uncut, on the flagship's gauge (the JAX
# run's jax.random gauge cannot be reproduced): the deflation space of an
# MdagM eigensolve (nEv 8, nKr 24, tol 1e-5, 20 restarts, Chebyshev deg
# 16 above 0.25, start vector seed 11), kappa 0.12, 4 Z4 noises (seeds
# 99 + i), CG tol 1e-5, deflated and plain
STOCH_EIG = dict(n_ev=8, n_kr=24, tol=1e-5, max_restarts=20,
                 check_interval=2, use_poly_acc=True, poly_deg=16,
                 a_min=0.25)
STOCH_EIG_SEED = 11
STOCH_KAPPA = 0.12
STOCH_NOISES = 4
STOCH_SEED = 99
STOCH_TOL = 1e-5
# the same recipe at 8^3x16 (random gauge, seed 1) through the kernels
# against the twins, within STOCH_TWIN_TOL of max |data|
STOCH_TWIN_DIMS = (8, 8, 8, 16)
STOCH_TWIN_NOISES = 2
STOCH_TWIN_TOL = 1e-5

# kernel vs twin: max |kernel - twin| / max |twin|.  Both run in f32 with
# the same inputs and differ only in summation order (K1, K6: half-spinor
# vs full projector form, ~100 terms per output; K2: n*3 terms; K3: 3).
TOL = {"wilson_m": 2e-5, "loop_contract": 2e-5, "covariant_displace": 1e-5,
       "parity_hop": 2e-5, "dslash_hop_dir": 2e-5, "identity": 1e-5,
       "wilson_m_halo": 2e-5, "parity_hop_halo": 2e-5,
       "dslash_hop": 2e-5, "dslash_hop_halo": 2e-5,
       # a bf16 output: one bf16 ulp (2^-8 relative) of the largest output
       # either way of a rounding boundary
       "dslash_hop_bf16": 2.0 ** -7, "wilson_m_bf16": 2.0 ** -7,
       "parity_hop_bf16": 2.0 ** -7, "wilson_m_halo_bf16": 2.0 ** -7,
       "dslash_hop_halo_bf16": 2.0 ** -7, "parity_hop_halo_bf16": 2.0 ** -7,
       # bf16-spinor halo blocks vs the bf16-spinor K1 / K4 / K6 on the
       # global field: both round an f32 result once, summed in other orders
       "slab_bf16": 2.0 ** -7,
       # K4 vs the eight K5 hops: the same hop code, summed in another order
       "hop_sum": 1e-6,
       # K7 / K4-halo blocks vs K1 / K4 / K6 on the global field: the same
       # per-site code
       "slab": 1e-6}

TPU_KERNEL = {
    "wilson_m": "mugiq_tpu/pallas/dslash_kernel.py:395",
    "loop_contract": "mugiq_tpu/pallas/contract_kernel.py:99",
    "covariant_displace": "mugiq_tpu/pallas/contract_kernel.py:192",
    "parity_hop": "mugiq_tpu/pallas/schur_kernel.py:350",
    "dslash_hop_dir": "mugiq_tpu/pallas/dslash_kernel.py:736",
    "wilson_m_halo": "mugiq_tpu/parallel/shard_dslash.py:112 (and :151, "
                     ":199, :314, :357)",
    "parity_hop_halo": "mugiq_tpu/pallas/schur_kernel.py:423 (and :486)",
    "dslash_hop": "mugiq_tpu/pallas/dslash_kernel.py:436 (and :726)",
    "dslash_hop_halo": "mugiq_tpu/parallel/shard_dslash.py:38 (and :74, "
                       ":199, :314, :357 with kappa=None)",
}
# the sources of the halo kernels' bf16-spinor forms (kernel, form) at the
# 32^3x64 rank-0 block (even X, aligned: K7a's and K4-halo's pairs)
BF16_PSI_SOURCE = {
    (k, f): f"mugiq_tpu_torch/kernels/csrc/{src}.cu"
    for k, f, src in (
        ("wilson_m_halo", "bf16_psi", "wilson_m_halo_pair"),
        ("wilson_m_halo", "all_bf16", "wilson_m_halo_pair"),
        ("dslash_hop_halo", "bf16_psi", "dslash_hop_halo_pair"),
        ("dslash_hop_halo", "all_bf16", "dslash_hop_halo_pair"),
        ("parity_hop_halo", "bf16_psi", "parity_hop_halo_psi_bf16"),
        ("parity_hop_halo", "all_bf16", "parity_hop_halo_all_bf16"))}
SOURCE = {
    "wilson_m": "mugiq_tpu_torch/kernels/csrc/wilson_m.cu",
    "loop_contract": "mugiq_tpu_torch/kernels/csrc/contract.cu",
    "covariant_displace": "mugiq_tpu_torch/kernels/csrc/contract.cu",
    "parity_hop": "mugiq_tpu_torch/kernels/csrc/parity_hop.cu",
    "dslash_hop_dir": "mugiq_tpu_torch/kernels/csrc/hop_dir.cu",
    "wilson_m_halo": "mugiq_tpu_torch/kernels/csrc/wilson_m_halo.cu",
    "parity_hop_halo": "mugiq_tpu_torch/kernels/csrc/parity_hop_halo.cuh",
    "dslash_hop": "mugiq_tpu_torch/kernels/csrc/dslash_hop.cu",
    "dslash_hop_halo": "mugiq_tpu_torch/kernels/csrc/dslash_hop_halo.cu",
}

# The 8^3x16 slices of the slice and pc-slice phases as CLI flags, for the
# mesh-slice phase
SLICE_ARGS = [
    "--dims", "8", "8", "8", "16", "--gauge", "weak:0.5", "--gauge-seed", "1",
    "--kappa", "0.13", "--eig-nev", "4", "--eig-nkr", "24", "--eig-tol", "1e-6",
    "--eig-max-restarts", "100", "--eig-use-poly-acc", "--eig-poly-deg", "12",
    "--eig-amin", "0.15", "--loop-do-nonlocal", "yes",
    "--displace-entry-string", "+z:1,2;-t:1", "--production"]
PC_SLICE_ARGS = [
    "--dims", "8", "8", "8", "16", "--gauge", "weak:0.5", "--gauge-seed", "1",
    "--kappa", "0.13", "--eig-nev", "4", "--eig-nkr", "24", "--eig-tol", "1e-6",
    "--eig-max-restarts", "100", "--eig-use-poly-acc", "--eig-poly-deg", "12",
    "--eig-amin", str(PC_SLICE_AMIN), "--solve-type", "direct-pc",
    "--production"]

# the pc slice with a bf16 basis (as the bf16-slice phase solves it: tol
# 1e-3, 40 restarts), for the mesh-slice phase
PC_SLICE_BF16_ARGS = PC_SLICE_ARGS + [
    "--basis-precision", "bf16", "--eig-tol", "1e-3",
    "--eig-max-restarts", "40"]

# the bf16 Krylov basis under --mesh (mesh-flagship): bf16 links and a
# bf16 basis, the JAX time_production32 recipe's precisions.  Its runs (one
# device, --mesh 1 1 and 2 1) stop at BF16_MESH_RESTARTS of the flagship's 30:
# a bf16 basis floors near bf16 eps (residual ~1e-2), so every such run
# goes to its cap, and the one-device reference stops at the same one
BF16_MESH_RESTARTS = 10
BF16_MESH_FLAGS = ["--link-precision", "bf16", "--basis-precision", "bf16",
                   "--eig-max-restarts", str(BF16_MESH_RESTARTS)]

# the Arnoldi of M at the slice (no CLI path; arnoldi_run): unfiltered,
# smallest modulus, nKr 48
ARNOLDI_SLICE_ARGS = [
    "--dims", "8", "8", "8", "16", "--gauge", "weak:0.5", "--gauge-seed", "1",
    "--kappa", "0.13", "--eig-nev", "4", "--eig-nkr", "48", "--eig-tol", "1e-6",
    "--eig-max-restarts", "200", "--production"]

# The API path (no --production) at the slice lattice through the loop
# CLI, in complex128 (--prec double, tol 1e-10) and complex64 (tol 1e-6),
# and the MG-coarse eigensolve (fp64; 2 levels, block 2^4, 6 null
# vectors) through the eigensolve CLI, for the api-slice phase.  The
# Chebyshev window's a_min 0.06 sits 20% above the fourth eigenvalue
# (0.04987, before a gap to 0.05020): 7 restarts where the slice's 0.15
# takes 12 (on the CPU, which api-slice runs too)
API_SLICE_ARGS = [
    "--dims", "8", "8", "8", "16", "--gauge", "weak:0.5", "--gauge-seed", "1",
    "--kappa", "0.13", "--eig-nev", "4", "--eig-nkr", "24",
    "--eig-max-restarts", "100", "--eig-use-poly-acc", "--eig-poly-deg", "16",
    "--eig-amin", "0.06", "--loop-do-nonlocal", "yes",
    "--displace-entry-string", "+z:1,2;-t:1"]
API_SLICE_PREC = {"double": ("1e-10", 1e-10, 1e-8),    # tol, evals, data_mom
                  "single": ("1e-6", 1e-5, 1e-4)}
API_MG_ARGS = [
    "--dims", "8", "8", "8", "16", "--gauge", "weak:0.5", "--gauge-seed", "1",
    "--kappa", "0.13", "--eig-nev", "4", "--eig-nkr", "24", "--eig-tol",
    "1e-10", "--eig-max-restarts", "300", "--prec", "double",
    "--mugiq-use-mg", "yes", "--mg-block-size", "2", "2", "2", "2",
    "--mg-nvec", "6", "--mg-setup-iters", "6"]

# The JAX package's error budget (scripts/error_budget16.py): 16^3x32,
# random gauge seed 3, Wilson kappa 0.12, nEv 8, three momenta; the fp64
# API loop (its cpu_reference recipe) against the f32 production loop
# (its chip recipe), both on the card, for the api-fp64 phase
BUDGET_DIMS = (16, 16, 16, 32)
BUDGET_MOMENTA = [(0, 0, 0), (1, 0, 0), (0, 1, 1)]
BUDGET_FP64 = dict(n_ev=8, n_kr=24, tol=1e-10, max_restarts=150,
                   check_interval=5, use_poly_acc=True, poly_deg=16,
                   a_min=0.25)
BUDGET_F32 = dict(n_ev=8, n_kr=24, tol=1e-6, max_restarts=60,
                  check_interval=2, use_poly_acc=True, poly_deg=16,
                  a_min=0.8)

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


# the scratch directory of one run (main makes and removes it) and the
# flagship gauge written there on first use
WORK = {"dir": None, "gauge": None}


def with_flagship_gauge(args):
    """args with their generated `--gauge` (random at 32^3x64) replaced by
    an ILDG file (f64, an exact copy) of that gauge: the host generator
    (numpy default_rng + SU(3) QR of 8.4 M matrices) takes ~27 s, so this
    run builds it once and every 32^3x64 CLI run reads the file."""
    if WORK["gauge"] is None:
        from mugiq_tpu_torch.io.gauge_io import load_gauge_np
        from mugiq_tpu_torch.io.lime_io import write_ildg_gauge
        from mugiq_tpu_torch.lattice import LatticeGeometry
        dims = [int(v) for v in args[args.index("--dims") + 1:][:4]]
        spec = args[args.index("--gauge") + 1]
        seed = int(args[args.index("--gauge-seed") + 1])
        t0 = time.perf_counter()
        U = load_gauge_np(spec, LatticeGeometry(dims), seed=seed)
        path = os.path.join(WORK["dir"], "flagship_gauge.lime")
        write_ildg_gauge(path, U)
        del U
        WORK["gauge"] = path
        say(f"flagship gauge: {spec}, seed {seed}, {dims}: built and written "
            f"as ILDG f64 in {time.perf_counter() - t0:.1f} s")
    a = list(args)
    a[a.index("--gauge") + 1] = WORK["gauge"]
    return a


def cuda_ms(fn, reps, warmup=2):
    """Median time of one fn() call in ms from CUDA events, after warm-up.
    With reps >= 10 (the kernels) each sample times a queue of QUEUE calls
    back to back, so that the host's launch overhead hides behind the
    previous launch, as on the main path, and not inside the kernel's
    time; with fewer (the twins' calls of many launches, and chains) each
    sample is one call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    n = QUEUE if reps >= 10 else 1
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / n)
    ts.sort()
    return ts[len(ts) // 2]


# calls in each timed queue of a kernel (cuda_ms)
QUEUE = 10


def bound(nbytes, flops):
    """Least time in ms: each input read once and each output written once
    at the HBM rate, or the f32 operations at the f32 peak, the larger."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(b_ms, f_ms),
            "bound_by": "bytes" if b_ms >= f_ms else "operations"}


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def misaligned(a):
    """A copy of `a` whose base is one element past a four-byte boundary:
    a bf16 operand that forces a stencil's one-site instance."""
    import torch
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    v = buf[1:].view(a.shape)
    v.copy_(a)
    return v


def compare(name, got, ref):
    import torch
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
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
    wall = time.perf_counter() - t0
    order = build.build_order(build.sources())
    secs = {}
    for name in order:
        m = re.search(r"nvcc ([0-9.]+) s", build.build_log(name))
        secs[name] = m.group(1) + " s" if m else "(built before)"
    say(f"build ({len(order)} sources, at most {build.build_jobs()} nvcc at "
        f"once, in this order): {wall:.2f} s; " + ", ".join(
            f"{n}.cu {v}" for n, v in secs.items()))
    for name in order:
        build.load(name)
        log = build.build_log(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                               log))
        say(f"  {name}.cu: nvcc {secs[name]}; ptxas: {len(regs)} kernels, "
            f"{min(regs, default=0)}-{max(regs, default=0)} registers, "
            f"{spill} bytes of spill stores")
    say("stencil instances (kernel<template arguments>, registers, spill "
        "store and load bytes), by source:")
    for name, inst in stencil_instances().items():
        say(f"  {name}.cu: {json.dumps(inst)}")


def stencil_sources():
    """The sources of the stencils' kernels: every source but K2's and
    K3's."""
    from mugiq_tpu_torch.kernels import build
    return [n for n in build.sources() if n != "contract"]


def ptxas_instances(log):
    """[(mangled kernel, registers, spill store bytes, spill load bytes)]
    from nvcc's -Xptxas -v output."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = [m.group(1), 0, 0, 0]
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur[2], cur[3] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur[1] = int(m.group(1))
    return out


def stencil_instances():
    """{source: [[kernel<template arguments>, registers, spill stores,
    spill loads], ...]} of the stencils' sources, names demangled by
    c++filt."""
    from mugiq_tpu_torch.kernels import build
    res = {}
    for name in stencil_sources():
        inst = ptxas_instances(build.build_log(name))
        names = [i[0] for i in inst]
        if names and shutil.which("c++filt"):
            names = subprocess.run(["c++filt"], input="\n".join(names),
                                   capture_output=True, text=True,
                                   check=True).stdout.splitlines()
        res[name] = [[(re.search(r"(\w+_kernel<[^>]*>)", n) or
                       re.search(r"(.*)", n)).group(1).replace(" ", ""),
                      *i[1:]] for n, i in zip(names, inst)]
    return res


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
    # the one PyTorch call that computes K2's function: the twin's einsum
    # on complex64 operands made before the timed window
    Lc = torch.complex(L[:, :, :12], L[:, :, 12:]).reshape(
        n, T, 4, 3, Z * Y * X).conj().resolve_conj()
    Rc = torch.complex(R[:, :, :12], R[:, :, 12:]).reshape(n, T, 4, 3,
                                                           Z * Y * X)
    wc = w.to(torch.complex64)
    lms = cuda_ms(lambda: torch.einsum("n,ntbcv,ntacv->tbav", wc, Lc, Rc),
                  20)
    del Lc, Rc
    say(f"K2 loop_contract n={n}: rel err {rel:.2e} (abs {err:.2e}, tol "
        f"{TOL['loop_contract']:.0e})  kernel {ms:.3f} ms (bound "
        f"{b['bound_ms']:.3f} ms by {b['bound_by']}, "
        f"{b['bound_ms'] / ms:.2f} of it)  twin {pms:.3f} ms  one "
        f"torch.einsum (complex64) {lms:.3f} ms")
    stats["loop_contract"] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                              "library_ms": lms, **b}
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
    """The slice at 8x4x4x8 through the kernels (card) vs the twins
    (CPU)."""
    import numpy as np
    from mugiq_tpu_torch.params import EigParam, LoopParam
    from mugiq_tpu_torch.production import compute_loop_production

    U, gp, ip = slice_setup()
    # n_ev = 4 ends at a gap of the spectrum (TWIN_DIMS)
    ep = EigParam(n_ev=4, n_kr=24, tol=1e-6, max_restarts=100,
                  use_poly_acc=True, poly_deg=12, a_min=TWIN_AMIN)
    lp = LoopParam(momenta=[(0, 0, 0), (1, 0, 0), (0, 1, 1)],
                   do_nonlocal=True, disp_entries=["+z:1,2", "-t:1"])
    out = {}
    for name, d in (("kernels", dev), ("twins", "cpu")):
        t0 = time.perf_counter()
        out[name] = compute_loop_production(U, gp, ip, ep, lp, device=d)
        r = out[name]
        say(f"slice 8x4x4x8 via {name} on {d}: {time.perf_counter() - t0:.2f}"
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


def _time_forms(name, tag, fn, plain, moved, flops, stats, key, extra=""):
    """Time one kernel form and its twin; say the line; return (ms,
    bound dict)."""
    ms = cuda_ms(fn, 20)
    pms = cuda_ms(plain, 3, 1)
    b = bound(moved, flops)
    say(f"{name} {tag}: kernel {ms:.3f} ms (bound {b['bound_ms']:.3f} ms by "
        f"{b['bound_by']}, {b['bound_ms'] / ms:.2f} of it){extra}  twin "
        f"{pms:.3f} ms")
    if key is not None:
        stats[key] = {"ms": ms, "plain_ms": pms, **b}
    return ms, b


def phase_bf16(dev, stats):
    """K1 and K6 with bf16 spinors (bf16 in, bf16 out) against their twins
    at 32^3x64 in every variant, within one bf16 ulp of max |out|; batched
    launches (b = 2, 3, 4; f32 and bf16 spinors) against single launches,
    exactly; every bf16-spinor and batched form timed with its bound and
    share."""
    import torch
    from mugiq_tpu_torch.kernels.parity import parity_hop, parity_hop_plain
    from mugiq_tpu_torch.kernels.wilson import (FLOP_PER_SITE, wilson_m,
                                                wilson_m_plain)

    T, Z, Y, X = KERNEL_SHAPE
    vol = T * Z * Y * X
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(7)
    psi = torch.randn((4, T, 24, Z, Y * X), generator=g, device=dev)
    U = torch.randn((T, 4, 18, Z, Y * X), generator=g, device=dev) * 0.5
    A = torch.randn((T, 144, Z, Y * X), generator=g, device=dev) * 0.2
    kappa = 0.12
    forms = {}
    worst = 0.0
    for prec, dt in (("f32", torch.float32), ("bf16", bf)):
        Ul, Al = U.to(dt), A.to(dt)
        for clover in (False, True):
            for dagger in (False, True):
                A144 = Al if clover else None
                p1 = psi[0].to(bf)
                ref = wilson_m_plain(p1, Ul, A144, kappa, dagger, Y)
                got = wilson_m(p1, Ul, A144, kappa, dagger, Y)
                err, rel = compare("wilson_m_bf16", got, ref)
                worst = max(worst, err)
                say(f"K1 wilson_m bf16 spinors, {prec} links, clover="
                    f"{int(clover)} dagger={int(dagger)}: rel err {rel:.2e} "
                    f"(abs {err:.2e}, tol {TOL['wilson_m_bf16']:.1e})")
                if not clover and not dagger:
                    out = torch.empty_like(p1)
                    key = "bf16_spinor" if prec == "f32" else "all_bf16"
                    _time_forms("K1 wilson_m", f"bf16 spinors, {prec} links",
                                lambda: wilson_m(p1, Ul, None, kappa, False,
                                                 Y, out=out),
                                lambda: wilson_m_plain(p1, Ul, None, kappa,
                                                       False, Y),
                                nbytes(p1, Ul, out), FLOP_PER_SITE * vol,
                                forms, key)
                del ref, got
    # batched launches: one launch for b vectors equals b single launches
    for sdt in (torch.float32, bf):
        p4 = psi.to(sdt)
        for b in (2, 3, 4):
            for dagger in (False, True):
                got = wilson_m(p4[:b], U, None, kappa, dagger, Y)
                one = torch.stack([wilson_m(p, U, None, kappa, dagger, Y)
                                   for p in p4[:b]])
                torch.cuda.synchronize()
                diff = float((got.float() - one.float()).abs().max())
                say(f"K1 wilson_m batch {b} ({str(sdt)[6:]} spinors) "
                    f"dagger={int(dagger)} vs {b} single launches: max abs "
                    f"diff {diff:.1e} (tol 0)")
                if diff != 0.0:
                    raise AssertionError("K1's batched launch differs from "
                                         "single launches")
                del got, one
        out4 = torch.empty_like(p4)
        outs = [torch.empty_like(p) for p in p4]
        ms1 = cuda_ms(lambda: [wilson_m(p, U, None, kappa, False, Y, out=o)
                               for p, o in zip(p4, outs)], 20)
        key = "batch4" if sdt == torch.float32 else "batch4_bf16"
        _time_forms("K1 wilson_m", f"batch 4 ({str(sdt)[6:]} spinors, one "
                    f"launch)",
                    lambda: wilson_m(p4, U, None, kappa, False, Y, out=out4),
                    lambda: wilson_m_plain(p4, U, None, kappa, False, Y),
                    nbytes(p4, U, out4), 4 * FLOP_PER_SITE * vol, forms, key,
                    f"; four single launches {ms1:.3f} ms")
        forms[key]["singles_ms"] = ms1
        del p4, out4, outs
    stats.setdefault("forms", {})["wilson_m"] = forms
    stats["forms"]["wilson_m"]["bf16_max_abs_err"] = worst
    del U, A
    torch.cuda.empty_cache()

    Xh = X // 2
    sites = T * Z * Y * Xh
    g = torch.Generator(device=dev).manual_seed(8)
    pin = torch.randn((4, T, 24, Z, Y * Xh), generator=g, device=dev)
    pe = torch.randn((4, T, 24, Z, Y * Xh), generator=g, device=dev)
    Uo = torch.randn((T, 4, 18, Z, Y * Xh), generator=g, device=dev) * 0.5
    Ui = torch.randn((T, 4, 18, Z, Y * Xh), generator=g, device=dev) * 0.5
    A = torch.randn((T, 144, Z, Y * Xh), generator=g, device=dev) * 0.2
    k2 = 0.12 ** 2
    forms = {}
    worst = 0.0
    for prec, dt in (("f32", torch.float32), ("bf16", bf)):
        Uol, Uil, Al = Uo.to(dt), Ui.to(dt), A.to(dt)
        p1, e1 = pin[0].to(bf), pe[0].to(bf)
        variants = (("pass1", {}), ("pass1+A_post", dict(A_post=Al)),
                    ("pass2", dict(kappa2=k2, psi_out=e1)),
                    ("pass2+A_comb", dict(kappa2=k2, psi_out=e1, A_comb=Al)))
        for tag, kw in variants:
            po = 1 if tag.startswith("pass1") else 0
            for dagger in (False, True):
                ref = parity_hop_plain(p1, Uol, Uil, Y, po, dagger, **kw)
                got = parity_hop(p1, Uol, Uil, Y, po, dagger, **kw)
                err, rel = compare("parity_hop_bf16", got, ref)
                worst = max(worst, err)
                say(f"K6 parity_hop bf16 spinors, {prec} links, {tag} "
                    f"dagger={int(dagger)}: rel err {rel:.2e} (abs {err:.2e},"
                    f" tol {TOL['parity_hop_bf16']:.1e})")
                del ref, got
            if tag == "pass1":
                out = torch.empty_like(p1)
                key = "bf16_spinor" if prec == "f32" else "all_bf16"
                _time_forms("K6 parity_hop", f"bf16 spinors, {prec} links, "
                            f"pass1",
                            lambda: parity_hop(p1, Uol, Uil, Y, 1, False,
                                               out=out),
                            lambda: parity_hop_plain(p1, Uol, Uil, Y, 1,
                                                     False),
                            nbytes(p1, Uol, Uil, out), FLOP_PER_SITE * sites,
                            forms, key)
    for sdt in (torch.float32, bf):
        p4, e4 = pin.to(sdt), pe.to(sdt)
        for b in (2, 3, 4):
            for tag, kw in (("pass1", {}),
                            ("pass2", dict(kappa2=k2, psi_out=e4[:b]))):
                po = 1 if tag == "pass1" else 0
                for dagger in (False, True):
                    got = parity_hop(p4[:b], Uo, Ui, Y, po, dagger, **kw)
                    one = torch.stack([
                        parity_hop(p, Uo, Ui, Y, po, dagger,
                                   **({} if not kw else
                                      dict(kappa2=k2, psi_out=e4[i])))
                        for i, p in enumerate(p4[:b])])
                    torch.cuda.synchronize()
                    diff = float((got.float() - one.float()).abs().max())
                    say(f"K6 parity_hop batch {b} ({str(sdt)[6:]} spinors) "
                        f"{tag} dagger={int(dagger)} vs {b} single launches: "
                        f"max abs diff {diff:.1e} (tol 0)")
                    if diff != 0.0:
                        raise AssertionError("K6's batched launch differs "
                                             "from single launches")
                    del got, one
        out4 = torch.empty_like(p4)
        outs = [torch.empty_like(p) for p in p4]
        ms1 = cuda_ms(lambda: [parity_hop(p, Uo, Ui, Y, 1, False, out=o)
                               for p, o in zip(p4, outs)], 20)
        key = "batch4" if sdt == torch.float32 else "batch4_bf16"
        _time_forms("K6 parity_hop", f"batch 4 ({str(sdt)[6:]} spinors, "
                    f"pass1, one launch)",
                    lambda: parity_hop(p4, Uo, Ui, Y, 1, False, out=out4),
                    lambda: parity_hop_plain(p4, Uo, Ui, Y, 1, False),
                    nbytes(p4, Uo, Ui, out4), 4 * FLOP_PER_SITE * sites,
                    forms, key, f"; four single launches {ms1:.3f} ms")
        forms[key]["singles_ms"] = ms1
        del p4, e4, out4, outs
    stats["forms"]["parity_hop"] = forms
    stats["forms"]["parity_hop"]["bf16_max_abs_err"] = worst
    torch.cuda.empty_cache()


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
    """The pc eigensolve at 8x4x4x8 through K6 (card) vs its twin
    (CPU)."""
    import numpy as np
    from mugiq_tpu_torch.params import EigParam
    from mugiq_tpu_torch.production import compute_evecs_production

    U, gp, ip = slice_setup()
    # n_ev = 4 ends at a gap of the pc spectrum (TWIN_DIMS)
    ep = EigParam(n_ev=4, n_kr=24, tol=1e-6, max_restarts=100,
                  use_poly_acc=True, poly_deg=12, a_min=TWIN_PC_AMIN)
    out = {}
    for name, d in (("kernels", dev), ("twins", "cpu")):
        t0 = time.perf_counter()
        res, evals, _, resids = compute_evecs_production(
            U, gp, ip, ep, even_odd=True, device=d)
        out[name] = evals
        say(f"pc slice 8x4x4x8 via {name} on {d}: "
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
        zero_counts(counters)
        t0 = time.perf_counter()
        res = run(argv)
        wall = time.perf_counter() - t0
        launches = read_counts(counters)
    finally:
        logger.removeHandler(handler)
    text = "\n".join(msgs)
    phases = {k: float(v) for k, v in re.findall(
        r"PROFILE\s+([\w-]+):\s+([0-9.]+)s", text)}
    for v in re.findall(r"Time for solution = ([0-9.]+) s", text):
        phases["solution"] = float(v)
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
        argv = with_flagship_gauge(FLAGSHIP_ARGS) + ["--momenta-filename",
                                                      mom]
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
    return launches, res


def phase_flagship_variant(name, flags, counters, flagship, ev_tol,
                           max_resid):
    """The loop flagship's CLI invocation with extra flags, on the
    script's flagship gauge: its eigenvalues within ev_tol relative of the
    f32 flagship's, max refined residual under max_resid, data_mom finite
    of the flagship's shape; returns (result, solution s, launches)."""
    import numpy as np
    from mugiq_tpu_torch.cli import loop as cli_loop

    tmp = tempfile.mkdtemp(prefix="mugiq_smoke_",
                           dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        mom = os.path.join(tmp, "moms.txt")
        with open(mom, "w") as f:
            f.write(FLAGSHIP_MOMENTA)
        argv = (with_flagship_gauge(FLAGSHIP_ARGS)
                + ["--momenta-filename", mom] + flags)
        say(f"{name} CLI: python -m mugiq_tpu_torch.cli.loop "
            + " ".join(argv))
        res, _, phases, launches = run_main_path(name, cli_loop.run, argv,
                                                 counters)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for i, (lam, r) in enumerate(zip(res.evals, res.resids)):
        say(f"{name}: eval[{i}] {lam:+.10e} resid {r:.3e}")
    ev = float(np.max(np.abs(res.evals - flagship.evals) / flagship.evals))
    say(f"{name}: solution {phases.get('solution', float('nan')):.3f} s, "
        f"converged={res.converged} restarts={res.n_restarts} (f32 flagship "
        f"{flagship.n_restarts}), evals rel {ev:.2e} of the f32 flagship's "
        f"(tol {ev_tol:.0e}), max resid {max(res.resids):.3e} (tol "
        f"{max_resid:.0e}), K1 launches {launches['wilson_m']}")
    if not (np.isfinite(res.evals).all() and ev <= ev_tol
            and max(res.resids) < max_resid):
        raise AssertionError(f"{name}: eigenpairs outside their limits")
    if res.data_mom.shape != (3, 2, 16, 64) or not np.isfinite(
            res.data_mom).all():
        raise AssertionError(f"{name} data_mom: shape {res.data_mom.shape} "
                             f"or not finite")
    if launches["wilson_m"] <= 0:
        raise AssertionError(f"{name}: K1 was not launched")
    return res, phases.get("solution"), launches


def phase_pc_flagship(counters):
    from mugiq_tpu_torch.cli import eigensolve as cli_eig

    argv = with_flagship_gauge(PC_FLAGSHIP_ARGS)
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


def phase_hop(dev, stats, counters, launches):
    """K4 against its twin on the card at 32^3x64 in all 16 variants; K4
    tied to K5 and K1; the masked preconditioned operator (two K4 hops per
    application) tied to K6 and timed, as K4's main path; the headline hop
    chains."""
    import torch
    from mugiq_tpu_torch.dirac_kernel import SchurDiracKernel
    from mugiq_tpu_torch.kernels.hop_dir import dslash_hop_dir
    from mugiq_tpu_torch.kernels.wilson import (FLOP_PER_SITE, aligned_pairs,
                                                dslash_hop, dslash_hop_plain,
                                                launch_plan, wilson_m)
    from mugiq_tpu_torch.schur_kernel import (SchurDiracKernelPacked,
                                              pack_parity, unpack_parities)

    T, Z, Y, X = KERNEL_SHAPE
    vol = T * Z * Y * X
    g = torch.Generator(device=dev).manual_seed(5)
    psi = torch.randn((T, 24, Z, Y * X), generator=g, device=dev)
    U = torch.randn((T, 4, 18, Z, Y * X), generator=g, device=dev) * 0.5
    types = {"f32": torch.float32, "bf16": torch.bfloat16}
    forms = stats.setdefault("forms", {}).setdefault("dslash_hop", {})
    worst, worst_bf16 = (0.0, 0.0), 0.0
    for pp, pdt in types.items():
        ps = psi.to(pdt)
        for lp, ldt in types.items():
            Ul = U.to(ldt)
            for op, odt in types.items():
                out = torch.empty(psi.shape, dtype=odt, device=dev)
                src = launch_plan("dslash_hop", 1, X, pp == "bf16",
                                  aligned_pairs(ps, Ul, out)).source
                for dagger in (False, True):
                    ref = dslash_hop_plain(ps, Ul, dagger, Y, odt)
                    got = dslash_hop(ps, Ul, dagger, Y, out_dtype=odt)
                    key = "dslash_hop_bf16" if op == "bf16" else "dslash_hop"
                    err, rel = compare(key, got, ref)
                    if op == "f32":
                        worst = max(worst, (rel, err))
                    else:
                        worst_bf16 = max(worst_bf16, err)
                    del ref, got
                    ms = cuda_ms(lambda: dslash_hop(ps, Ul, dagger, Y,
                                                    out=out), 20)
                    moved = nbytes(ps, Ul, out)
                    b = bound(moved, FLOP_PER_SITE * vol)
                    say(f"K4 dslash_hop psi {pp} links {lp} out {op} "
                        f"dagger={int(dagger)}: rel err {rel:.2e} (abs "
                        f"{err:.2e}, tol {TOL[key]:.1e})  kernel {ms:.3f} ms "
                        f"({FLOP_PER_SITE * vol / ms / 1e6:.0f} GFLOP/s; "
                        f"bound {b['bound_ms']:.3f} ms by {b['bound_by']}, "
                        f"{b['bound_ms'] / ms:.2f} of it; {src}.cu)")
                    if (pp, lp, op, dagger) == ("f32", "f32", "f32", False):
                        pms = cuda_ms(lambda: dslash_hop_plain(ps, Ul, dagger,
                                                               Y), 5, 1)
                        say(f"K4 f32 D: twin {pms:.3f} ms")
                        stats["dslash_hop"] = {"ms": ms, "plain_ms": pms,
                                               "library_ms": None, **b}
                    if (pp, lp, op, dagger) == ("bf16", "bf16", "bf16",
                                                False):
                        pms = cuda_ms(lambda: dslash_hop_plain(ps, Ul, dagger,
                                                               Y), 5, 1)
                        say(f"K4 all-bf16 D: twin {pms:.3f} ms")
                        forms["all_bf16"] = {
                            "ms": ms, "plain_ms": pms, **b,
                            "source": f"mugiq_tpu_torch/kernels/csrc/"
                                      f"{src}.cu"}
                del out
            del Ul
        del ps
        torch.cuda.empty_cache()
    stats["dslash_hop"]["max_abs_err"] = worst[1]

    # the one-site bf16 instance (an odd X or a misaligned base), forced
    # by a base two bytes off a four-byte boundary: against its twin, and
    # timed beside the pair form above
    ps = misaligned(psi.to(torch.bfloat16))
    for lp, ldt in types.items():
        Ul = U.to(ldt)
        out = misaligned(torch.empty_like(ps))
        plan = launch_plan("dslash_hop", 1, X, True,
                           aligned_pairs(ps, Ul, out))
        if plan.pair:
            raise AssertionError("K4: a misaligned base planned as pairs")
        for dagger in (False, True):
            got = dslash_hop(ps, Ul, dagger, Y, out=out)
            err, rel = compare("dslash_hop_bf16", got,
                               dslash_hop_plain(ps, Ul, dagger, Y))
            worst_bf16 = max(worst_bf16, err)
            say(f"K4 dslash_hop bf16 spinors, {lp} links, one site a thread "
                f"({plan.source}.cu, misaligned base) dagger={int(dagger)}: "
                f"rel err {rel:.2e} (abs {err:.2e}, tol "
                f"{TOL['dslash_hop_bf16']:.1e})")
        ms = cuda_ms(lambda: dslash_hop(ps, Ul, False, Y, out=out), 20)
        b = bound(nbytes(ps, Ul, out), FLOP_PER_SITE * vol)
        say(f"K4 dslash_hop bf16 spinors, {lp} links, out bf16, one site a "
            f"thread D: kernel {ms:.3f} ms (bound {b['bound_ms']:.3f} ms, "
            f"{b['bound_ms'] / ms:.2f} of it)")
        if lp == "bf16":
            forms["all_bf16"]["one_site_ms"] = ms
        del Ul, out
    forms["bf16_max_abs_err"] = worst_bf16
    del ps

    # K4 = the eight K5 hops; psi - kappa K4(psi) = K1(psi) (Wilson)
    kappa = 0.12
    out = torch.empty_like(psi)
    for lp, ldt in types.items():
        Ul = U.to(ldt)
        for dagger in (False, True):
            k4 = dslash_hop(psi, Ul, dagger, Y)
            acc = torch.zeros_like(psi)
            for mu in range(4):
                for sgn in (1, -1):
                    acc += dslash_hop_dir(psi, Ul, mu, sgn, dagger, Y,
                                          out=out)
            _, rel = compare("hop_sum", k4, acc)
            k1 = wilson_m(psi, Ul, None, kappa, dagger, Y)
            _, rel1 = compare("identity", psi - kappa * k4, k1)
            say(f"identity K4 links {lp} dagger={int(dagger)}: vs the sum "
                f"of the eight K5 hops rel {rel:.2e} (tol "
                f"{TOL['hop_sum']:.0e}); psi - kappa K4 vs K1 rel {rel1:.2e} "
                f"(tol {TOL['identity']:.0e})")
            del k4, acc, k1
    del out

    # the masked operator (JAX dirac_kernel.SchurDiracKernel) against K6's
    # packed M_pc on an even field, and its time beside K6's
    masked = SchurDiracKernel(U, kappa, Y)
    packed = SchurDiracKernelPacked(U, kappa, Y)
    pe = torch.randn(packed.field_shape, generator=g, device=dev)
    zero = torch.zeros_like(pe)
    x = unpack_parities(pe, zero, Y)
    for dagger in (False, True):
        name = "Mdag" if dagger else "M"
        got = getattr(masked, name)(x)
        ref = unpack_parities(getattr(packed, name)(pe), zero, Y)
        _, rel = compare("identity", got, ref)
        odd = float(pack_parity(got, Y, 1).abs().max())
        say(f"masked M_pc ({name}) vs unpack(K6 packed M_pc): rel {rel:.2e} "
            f"(tol {TOL['identity']:.0e}), odd half max |.| {odd:.1e}")
        if odd != 0.0:
            raise AssertionError("the masked M_pc leaves the even sites")
        del got, ref
    mms = cuda_ms(lambda: masked.M(x), 20)
    pms = cuda_ms(lambda: packed.M(pe), 20)
    say(f"masked M_pc (2 K4 + 2 masks, full volume) {mms:.3f} ms; packed "
        f"M_pc (2 K6 passes, half volume) {pms:.3f} ms; ratio "
        f"{mms / pms:.2f}")
    # K4's main path: applications of the masked MdagM, every launch
    # counter zeroed just before and read just after
    n_app = 50
    v = x.clone()
    zero_counts(counters)
    for _ in range(n_app):
        v = masked.MdagM(v)
        v = v / v.norm()
    torch.cuda.synchronize()
    got = read_counts(counters)
    say(f"masked MdagM x {n_app}: launches {json.dumps(got)}")
    if got["dslash_hop"] != 4 * n_app or got["wilson_m"] or \
            got["parity_hop"]:
        raise AssertionError("the masked operator did not run on K4 alone")
    if not bool(torch.isfinite(v).all()):
        raise AssertionError("the masked MdagM chain is not finite")
    launches["dslash_hop"] = got["dslash_hop"]
    del masked, packed, pe, zero, x, v
    torch.cuda.empty_cache()

    # the headline hop: a chain of K4 applications, each output the next
    # input (bench.py's measurement of dslash_hop_pallas), median of CUDA
    # event timings of the whole chain over the chain length
    card = card_line()
    for dims, prec, n in (((32, 16, 16, 16), "f32", 400),
                          (KERNEL_SHAPE, "f32", 100),
                          (KERNEL_SHAPE, "bf16", 100)):
        t, z, y, xx = dims
        dt = types[prec]
        sites = t * z * y * xx
        a = torch.randn((t, 24, z, y * xx), generator=g, device=dev).to(dt)
        Ul = (torch.randn((t, 4, 18, z, y * xx), generator=g, device=dev)
              * 0.3).to(dt)
        b_ = torch.empty_like(a)

        def chain():
            p, q = a, b_
            for _ in range(n):
                dslash_hop(p, Ul, False, y, out=q)
                p, q = q, p

        ms = cuda_ms(chain, 5, 1) / n
        bnd = bound(nbytes(a, Ul, b_), FLOP_PER_SITE * sites)
        say(f"headline K4 hop {xx}^3x{t} {prec} (psi, links, out): "
            f"{ms * 1e3:.1f} us per application over a chain of {n}, "
            f"{FLOP_PER_SITE * sites / ms / 1e6:.0f} GFLOP/s at "
            f"{FLOP_PER_SITE} flop/site, bound {bnd['bound_ms'] * 1e3:.1f} "
            f"us by {bnd['bound_by']}, {bnd['bound_ms'] / ms:.2f} of it; "
            f"card {card}")
        del a, b_, Ul
        torch.cuda.empty_cache()


def match_rel(a, b):
    """Max over a's eigenvalues of the relative distance to the nearest of
    b's: an order-free comparison (complex conjugate pairs of M have equal
    modulus and sort by rounding noise)."""
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    return float(max(np.min(np.abs(b - x)) / np.abs(x) for x in a))


def slice_setup():
    """The twin slices' gauge and parameters (TWIN_DIMS, weak:0.5, seed 1,
    kappa 0.13)."""
    from mugiq_tpu_torch.io.gauge_io import load_gauge_np
    from mugiq_tpu_torch.lattice import LatticeGeometry
    from mugiq_tpu_torch.params import GaugeParam, InvertParam

    geom = LatticeGeometry(TWIN_DIMS)
    return (load_gauge_np("weak:0.5", geom, seed=1),
            GaugeParam(dims=geom.dims), InvertParam(kappa=0.13))


def solve_counted(name, d, counters, **kw):
    """compute_evecs_production on the slice through device d, every launch
    counter zeroed just before and read just after; returns (res, evals,
    resids, launches)."""
    from mugiq_tpu_torch.production import compute_evecs_production

    U, gp, ip = slice_setup()
    zero_counts(counters)
    t0 = time.perf_counter()
    res, evals, _, resids = compute_evecs_production(U, gp, ip, device=d,
                                                     **kw)
    launches = read_counts(counters)
    say(f"{name} on {d}: {time.perf_counter() - t0:.2f} s, converged="
        f"{res.converged} restarts={res.n_restarts} max resid "
        f"{max(resids):.2e}")
    return res, evals, resids, launches


def phase_bf16_restart(dev, stats):
    """The JAX package's TPU restart bench through the port
    (bench.py:225-261, _bench_eig32_restart): 32^3x64, random-normal links,
    MdagM, nKr 24, nEv 8, tol 1e-30; warm seconds per restart from the
    difference of 6 and 2 restarts.  Once with bf16 links and a bf16 basis
    (the bench's configuration), once with f32 links and an f32 basis."""
    import numpy as np
    import torch
    from mugiq_tpu_torch.dirac_kernel import WilsonDiracKernel
    from mugiq_tpu_torch.lanczos import lanczos_hermitian_realpair

    T, Z, Y, X = KERNEL_SHAPE
    rng = np.random.default_rng(0)
    U = torch.from_numpy(rng.standard_normal((T, 4, 18, Z, Y * X)).astype(
        np.float32)).to(dev)
    v0 = torch.from_numpy(rng.standard_normal((T, 24, Z, Y * X)).astype(
        np.float32)).to(dev)
    card = card_line()
    out = {}
    for tag, prec, bdt in (("bf16 links + bf16 basis", "bf16", torch.bfloat16),
                           ("f32 links + f32 basis", "f32", None)):
        op = WilsonDiracKernel(U, 0.12, Y, precision=prec)

        def run(r):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lanczos_hermitian_realpair(
                op.MdagM, v0, n_ev=8, n_kr=24, re_im_axis=1, tol=1e-30,
                max_restarts=r, which="SR", check_interval=100,
                basis_dtype=bdt)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        run(2)                                  # warm
        t2, t6 = run(2), run(6)
        per = (t6 - t2) / 4
        out[prec] = per
        say(f"bf16-restart 32^3x64 {tag}: 2 restarts {t2:.3f} s, 6 restarts "
            f"{t6:.3f} s, warm {per:.4f} s/restart ({card})")
        del op
        torch.cuda.empty_cache()
    stats["restart_s"] = {"bf16": out["bf16"], "f32": out["f32"],
                          "card": card}


def phase_bf16_slice(dev, counters, launches):
    """The bf16-basis eigensolve at 8x4x4x8 through the kernels (card), full
    operator (K1, also through the twins on the CPU) and packed pc operator
    (K6): eigenvalues within 1e-2 relative of the twins' and within 3e-2
    of the f32 solve on the card, residuals < 0.1; fills `launches` with
    the bf16 launches."""
    import numpy as np
    from mugiq_tpu_torch.params import EigParam

    for eo, amin, kern in ((False, TWIN_AMIN, "wilson_m"),
                           (True, TWIN_PC_AMIN, "parity_hop")):
        tag = "pc" if eo else "full"
        # the twins' CPU time: the full operator only (K6's bf16 form is
        # held to its twin in the bf16 phase)
        devices = (("kernels", dev),) if eo else (("kernels", dev),
                                                  ("twins", "cpu"))
        ref = solve_counted(f"bf16 slice {tag} f32 basis", dev, counters,
                            eig=EigParam(n_ev=4, n_kr=24, tol=1e-6,
                                         max_restarts=100, use_poly_acc=True,
                                         poly_deg=12, a_min=amin),
                            even_odd=eo)[1]
        ep = EigParam(n_ev=4, n_kr=24, tol=1e-3, max_restarts=40,
                      use_poly_acc=True, poly_deg=12, a_min=amin)
        got = {}
        for name, d in devices:
            _, got[name], resids, lk = solve_counted(
                f"bf16 slice {tag} bf16 basis via {name}", d, counters,
                eig=ep, even_odd=eo, basis_precision="bf16")
            if max(resids) >= 0.1:
                raise AssertionError(f"bf16 slice {tag} via {name}: max "
                                     f"residual {max(resids):.3e} >= 0.1")
            if name == "kernels":
                launches[kern] = lk[kern]
                if lk[kern] <= 0:
                    raise AssertionError(f"bf16 slice {tag}: {kern} was "
                                         f"not launched")
        kt = (float(np.max(np.abs(got["kernels"] - got["twins"])
                           / got["twins"])) if "twins" in got else 0.0)
        kf = float(np.max(np.abs(got["kernels"] - ref) / ref))
        vs = f"{kt:.2e}" if "twins" in got else "not run"
        say(f"bf16 slice {tag}: kernels vs twins evals rel {vs} (tol 1e-2), "
            f"vs the f32 basis {kf:.2e} (tol 3e-2); {kern} launches "
            f"{launches[kern]}")
        if not (kt <= 1e-2 and kf <= 3e-2):
            raise AssertionError(f"bf16 slice {tag} disagrees")


def phase_block_slice(dev, counters):
    """Block Lanczos (b = 4) of the pc eigensolve at 8x4x4x8 through K6's
    batched launch (card) against the twins (CPU) and the b = 1 solve:
    eigenvalues 1e-5; returns K6's launches."""
    import numpy as np
    from mugiq_tpu_torch.params import EigParam

    out = {}
    for name, b, d in (("b=4 kernels", 4, dev), ("b=4 twins", 4, "cpu"),
                       ("b=1 kernels", 1, dev)):
        res, out[name], _, lk = solve_counted(
            f"block slice pc {name}", d, counters, even_odd=True,
            eig=EigParam(n_ev=4, n_kr=24, tol=1e-6, max_restarts=100,
                         use_poly_acc=True, poly_deg=12,
                         a_min=TWIN_PC_AMIN, block_size=b))
        if not res.converged:
            raise AssertionError(f"block slice {name} did not converge")
        if name == "b=4 kernels":
            k6 = lk["parity_hop"]
            if k6 <= 0:
                raise AssertionError("block slice: K6 was not launched")
    a = out["b=4 kernels"]
    kt = float(np.max(np.abs(a - out["b=4 twins"]) / out["b=4 twins"]))
    k1 = float(np.max(np.abs(a - out["b=1 kernels"]) / out["b=1 kernels"]))
    say(f"block slice pc: kernels vs twins evals rel {kt:.2e} (tol 1e-5), "
        f"vs b=1 {k1:.2e} (tol 1e-5); K6 launches {k6} (batched)")
    if not (kt <= 1e-5 and k1 <= 1e-5):
        raise AssertionError("block slice disagrees")
    return k6


def arnoldi_run(argv):
    """The Arnoldi eigensolve of EigOperator.M, which no CLI reaches: the
    eigensolve CLI's flags, parsed, solved by
    production.compute_evecs_production for the smallest modulus,
    unfiltered, on the mesh the flags ask for; returns what the CLI's
    run() returns."""
    from mugiq_tpu_torch.cli import eigensolve as cli_eig
    from mugiq_tpu_torch.cli.common import build_mesh, build_params
    from mugiq_tpu_torch.io.gauge_io import load_gauge_np
    from mugiq_tpu_torch.lattice import LatticeGeometry
    from mugiq_tpu_torch.params import EigOperator, Spectrum
    from mugiq_tpu_torch.production import compute_evecs_production

    args = cli_eig.parse_args(argv)
    gp, ip, ep = build_params(args)
    ep.operator, ep.spectrum, ep.use_poly_acc = (EigOperator.M, Spectrum.SM,
                                                 False)
    mesh, dev = build_mesh(args, gp.dims)
    U = load_gauge_np(args.gauge, LatticeGeometry(gp.dims),
                      seed=args.gauge_seed)
    return compute_evecs_production(U, gp, ip, ep, seed=ep.seed, mesh=mesh,
                                    device=dev)


def phase_arnoldi_slice(dev, counters):
    """compute_evecs_production with EigOperator.M and Mdag at 8x4x4x8 (the
    Krylov-Schur Arnoldi, smallest modulus) through the kernels (card)
    against the twins (CPU): eigenvalues 1e-5 relative; M^dag's the
    conjugates of M's."""
    import numpy as np
    from mugiq_tpu_torch.params import EigOperator, EigParam, Spectrum

    got = {}
    for op in ("M", "Mdag"):
        ep = EigParam(n_ev=4, n_kr=48, tol=1e-6, max_restarts=200,
                      operator=EigOperator[op], spectrum=Spectrum.SM)
        for name, d in (("kernels", dev), ("twins", "cpu")):
            res, got[(op, name)], resids, lk = solve_counted(
                f"arnoldi slice {op} via {name}", d, counters, eig=ep)
            if not res.converged:
                raise AssertionError(f"arnoldi slice {op} via {name} did "
                                     f"not converge")
            say(f"arnoldi slice {op} via {name}: evals "
                f"{np.round(got[(op, name)], 6).tolist()}, resids "
                f"{[f'{r:.2e}' for r in resids]}, K1 launches "
                f"{lk['wilson_m']}")
        kt = match_rel(got[(op, "kernels")], got[(op, "twins")])
        say(f"arnoldi slice {op}: kernels vs twins evals rel {kt:.2e} (tol "
            f"1e-5)")
        if not kt <= 1e-5:
            raise AssertionError(f"arnoldi slice {op} disagrees")
    cj = match_rel(got[("Mdag", "kernels")], np.conj(got[("M", "kernels")]))
    say(f"arnoldi slice: Mdag evals vs conj(M evals) rel {cj:.2e} (tol 1e-5)")
    if not cj <= 1e-5:
        raise AssertionError("M^dag's eigenvalues are not M's conjugates")


def api_run(cli_name, argv):
    """One API-path CLI run (cli_name loop or eig) -> (seconds, restarts,
    converged, max residual, evals, data_mom or None, evecs,
    EigsolveResult)."""
    from mugiq_tpu_torch.cli import eigensolve as cli_eig
    from mugiq_tpu_torch.cli import loop as cli_loop

    t0 = time.perf_counter()
    if cli_name == "loop":
        loop, eig = cli_loop.run(argv)
        data_mom = loop.data_mom
    else:
        eig = cli_eig.run(argv)[0]
        data_mom = None
    out = eig.output
    return (time.perf_counter() - t0, out.n_restarts, bool(out.converged),
            float(out.resids.max()), out.evals, data_mom, out.evecs, eig)


def api_jobs():
    """{name: (cli, argv)} of api-slice: the loop in complex128 and
    complex64, the MG-coarse eigensolve in complex128."""
    mom = os.path.join(WORK["dir"], "api_moms.txt")
    with open(mom, "w") as f:
        f.write(FLAGSHIP_MOMENTA)
    jobs = {f"loop {prec}": ("loop", API_SLICE_ARGS + [
                "--prec", prec, "--eig-tol", tol, "--momenta-filename", mom])
            for prec, (tol, _, _) in API_SLICE_PREC.items()}
    jobs["MG eigensolve double"] = ("eig", API_MG_ARGS)
    return jobs


def phase_api_slice():
    """The API path (the CLIs without --production) at 8^3x16 on the card
    against the same runs on the CPU, one after the other in this
    process: the loop in complex128 and complex64, the MG-coarse
    eigensolve in complex128 and the coarse-space ultra-local loop of its
    eigenpairs (mg.coarse_loop.coarse_loop_ulocal, weights 1/Re(lambda),
    FLAGSHIP_MOMENTA; card vs CPU within 1e-10 of max |L|)."""
    import numpy as np
    import torch

    jobs = api_jobs()
    card, cpu = {}, {}
    for name, (cli, argv) in jobs.items():
        r = api_run(cli, argv + ["--device", "cuda"])
        if r[6].device.type != "cuda":
            raise AssertionError(f"api {name}: the API path left the card")
        card[name] = r
    # PyTorch's intra-op threads default to every host core
    say(f"api slice: CPU runs on {torch.get_num_threads()} threads")
    for name, (cli, argv) in jobs.items():
        cpu[name] = api_run(cli, argv + ["--device", "cpu"])
    for name in jobs:
        for d, r in (("cuda", card[name]), ("cpu", cpu[name])):
            say(f"api {name} on {d}: {r[0]:.2f} s, converged={r[2]} "
                f"restarts={r[1]} max resid {r[3]:.2e}")
            if not r[2]:
                raise AssertionError(f"api {name} on {d} did not converge")
        a, b = card[name], cpu[name]
        ev_rel = float(np.max(np.abs(a[4] - b[4]) / np.abs(b[4])))
        prec = "double" if "double" in name else "single"
        _, ev_tol, dm_tol = API_SLICE_PREC[prec]
        if b[5] is None:
            # the MG-coarse eigensolve: coarse eigenvalues only
            dm, dm_tol = 0.0, 0.0
        else:
            dm = float(np.linalg.norm(a[5] - b[5]) / np.linalg.norm(b[5]))
            if not np.all(np.isfinite(a[5])):
                raise AssertionError(f"api {name}: data_mom not finite")
        say(f"api {name}, card vs CPU: evals rel {ev_rel:.2e} (tol "
            f"{ev_tol:g}), data_mom normwise {dm:.2e} (tol {dm_tol:g})")
        if not (ev_rel <= ev_tol and dm <= dm_tol):
            raise AssertionError(f"api {name}: card disagrees with CPU")
    from mugiq_tpu_torch.mg.coarse_loop import coarse_loop_ulocal
    momenta = [tuple(int(v) for v in ln.split())
               for ln in FLAGSHIP_MOMENTA.splitlines()]
    loops = {}
    for d, r in (("cuda", card["MG eigensolve double"]),
                 ("cpu", cpu["MG eigensolve double"])):
        eig = r[7]
        t0 = time.perf_counter()
        loops[d] = coarse_loop_ulocal(eig.mg_env, eig.evecs,
                                      1.0 / np.asarray(eig.evals).real,
                                      eig.geom, momenta)
        say(f"api coarse loop on {d}: {time.perf_counter() - t0:.3f} s, "
            f"shape {loops[d].shape}, |L|_max {np.abs(loops[d]).max():.6e}")
    err = float(np.abs(loops["cuda"] - loops["cpu"]).max()
                / np.abs(loops["cpu"]).max())
    say(f"api coarse loop, card vs CPU: rel {err:.2e} (tol 1e-10)")
    if not (err <= 1e-10 and np.isfinite(loops["cuda"]).all()):
        raise AssertionError("api coarse loop: card disagrees with CPU")


def api_operator_ms(U, gp, ip, dev):
    """The API path's M and M^dag M at the budget's lattice, complex128
    and complex64: CUDA events over 20 applications after a warm-up."""
    import torch
    from mugiq_tpu_torch.dirac import make_dirac

    out = {}
    for name, dt in (("complex128", torch.complex128),
                     ("complex64", torch.complex64)):
        d = make_dirac(torch.as_tensor(U).to(dev, dt), gp, ip)
        psi = torch.randn(d.field_shape, dtype=dt, device=dev)
        for op in ("M", "MdagM"):
            f = getattr(d, op)
            f(psi)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(20):
                f(psi)
            e1.record()
            torch.cuda.synchronize()
            out[f"{op} {name}"] = e0.elapsed_time(e1) / 20
    return out


def phase_api_fp64(dev):
    """The error budget of scripts/error_budget16.py on the card: the fp64
    API loop converged (max computeEvals residual <= 1e-8), the f32
    production loop (< 1e-3, evals within 1e-5 of fp64), and the
    correlators' relative error, printed."""
    import numpy as np
    import torch
    from mugiq_tpu_torch import api
    from mugiq_tpu_torch.io.gauge_io import load_gauge_np
    from mugiq_tpu_torch.lattice import LatticeGeometry
    from mugiq_tpu_torch.params import (EigParam, GaugeParam, InvertParam,
                                        LoopParam)
    from mugiq_tpu_torch.production import compute_loop_production

    geom = LatticeGeometry(BUDGET_DIMS)
    U = load_gauge_np("random", geom, seed=3)
    gp = GaugeParam(dims=geom.dims)
    ip = InvertParam(kappa=0.12)
    lp = LoopParam(momenta=BUDGET_MOMENTA)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, eig = api.compute_loop(U, gp, ip, EigParam(**BUDGET_FP64), lp,
                                dtype=torch.complex128, device=dev)
    torch.cuda.synchronize()
    t64 = time.perf_counter() - t0
    r64 = float(eig.output.resids.max())
    say(f"api-fp64: fp64 API loop {t64:.2f} s, converged="
        f"{eig.output.converged} restarts={eig.output.n_restarts} max resid "
        f"{r64:.3e} (gate 1e-8)")
    t0 = time.perf_counter()
    res = compute_loop_production(U, gp, ip, EigParam(**BUDGET_F32), lp,
                                  device=dev)
    torch.cuda.synchronize()
    t32 = time.perf_counter() - t0
    r32 = float(max(res.resids))
    say(f"api-fp64: f32 production loop {t32:.2f} s, converged="
        f"{res.converged} restarts={res.n_restarts} max resid {r32:.3e} "
        f"(gate 1e-3)")
    ev64 = np.asarray(eig.evals).real
    ev_rel = float(np.max(np.abs(np.asarray(res.evals) - ev64) / ev64))
    a, b = np.asarray(res.data_mom), np.asarray(ref.data_mom)
    if a.shape != b.shape:
        raise AssertionError(f"data_mom shapes {a.shape} != {b.shape}")
    # entries above 1e-6 of the largest, as scripts/error_budget16.py
    # masks the physically zero ones
    mask = np.abs(b) > 1e-6 * np.abs(b).max()
    rel = np.abs(a - b)[mask] / np.abs(b)[mask]
    budget = {
        "dims": list(BUDGET_DIMS), "n_ev": BUDGET_FP64["n_ev"],
        "fp64": {"max_resid": r64, "seconds": t64,
                 "restarts": eig.output.n_restarts,
                 "converged": bool(eig.output.converged)},
        "f32": {"max_resid": r32, "seconds": t32,
                "restarts": res.n_restarts, "converged": bool(res.converged)},
        "eval_rel_err_max": ev_rel,
        "correlator_rel_err_normwise": float(np.linalg.norm(a - b)
                                             / np.linalg.norm(b)),
        "correlator_rel_err_median": float(np.median(rel)),
        "correlator_rel_err_max": float(rel.max()),
        "entries_compared": int(mask.sum()),
        "card": card_line()}
    budget["M_ms"] = api_operator_ms(U, gp, ip, dev)
    say(json.dumps({"error_budget16": budget}))
    if not (eig.output.converged and r64 <= 1e-8):
        raise AssertionError(f"api-fp64: the fp64 loop did not converge to "
                             f"residual 1e-8 ({r64:.3e})")
    if not (r32 < 1e-3 and ev_rel <= 1e-5 and np.all(np.isfinite(a))):
        raise AssertionError(f"api-fp64: f32 production residual {r32:.3e} "
                             f"or evals rel {ev_rel:.3e} out of bounds")


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
    from mugiq_tpu_torch.cli import loop as cli_loop

    tmp = tempfile.mkdtemp(prefix="mugiq_smoke_",
                           dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        mom = os.path.join(tmp, "moms.txt")
        with open(mom, "w") as f:
            f.write(MG_FLAGSHIP_MOMENTA)
        argv = with_flagship_gauge(MG_FLAGSHIP_ARGS) + ["--momenta-filename",
                                                         mom]
        say("mg flagship CLI: python -m mugiq_tpu_torch.cli.loop "
            + " ".join(argv))
        res, _, _, launches = run_main_path("mg flagship", cli_loop.run,
                                            argv, counters)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_mg_flagship("mg flagship", res)
    for name in ("wilson_m", "loop_contract", "covariant_displace",
                 "dslash_hop_dir"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the mg "
                                 f"flagship run")
    return res, launches


def check_mg_flagship(name, res):
    """An MG flagship run (evals, resids, converged, n_restarts, data_mom):
    converged, coarse residuals <= MG_MAX_RESIDUAL, the four lowest coarse
    eigenvalues within MG_EVALS_RTOL of the JAX record, data_mom finite of
    the flagship's shape."""
    import numpy as np
    say(f"{name}: converged={bool(res.converged)} "
        f"restarts={int(res.n_restarts)}")
    for i, (lam, r) in enumerate(zip(res.evals, res.resids)):
        say(f"{name}: coarse eval[{i}] {lam:+.10e} resid {r:.3e}")
    if not res.converged or not max(res.resids) <= MG_MAX_RESIDUAL:
        raise AssertionError(f"{name}: converged={bool(res.converged)}, max "
                             f"coarse residual {max(res.resids):.3e} (limit "
                             f"{MG_MAX_RESIDUAL})")
    rel = np.abs(res.evals[:4] - np.asarray(MG_COARSE_EVALS4)) \
        / np.asarray(MG_COARSE_EVALS4)
    say(f"{name}: four lowest coarse evals vs the JAX record: rel "
        f"{' '.join(f'{x:.2e}' for x in rel)} (tol {MG_EVALS_RTOL:.0e})")
    if not np.all(rel <= MG_EVALS_RTOL):
        raise AssertionError(f"{name}: coarse eigenvalues disagree with the "
                             f"JAX record")
    if res.data_mom.shape != (2, 2, 16, 64) or not np.isfinite(
            res.data_mom).all():
        raise AssertionError(f"{name} data_mom: shape {res.data_mom.shape} "
                             f"or not finite")


class _Ranked:
    """A rank's saved results with the attributes of a ProductionResult."""

    def __init__(self, d):
        self.evals, self.resids = d["evals"], d["resids"]
        self.data_mom = d["data_mom"]
        self.converged = bool(d["converged"])
        self.n_restarts = int(d["n_restarts"])


def phase_mg_mesh(mg_flagship, counters):
    """The MG flagship over --mesh 2 1 (two gloo ranks sharing the card):
    the null vectors smoothed on K7a, the Galerkin probed with K5 across
    the rank edge, the coarse operator gathered and eigensolved on both
    ranks, the sharded measurement (K2, K3).  Before the loop, in the same
    launch, the Galerkin's hops (block_hops: K5 on each rank's block,
    extended along t) held to K5's twin on the global field.  Every rank
    passes the MG flagship's checks and is held to the one-device run:
    coarse eigenvalues 1e-4 relative, data_mom 1e-3 of max, the same
    restarts on both ranks; K7a, K5, K2 and K3 launched, K1 not.  Returns
    the hops' largest abs error."""
    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="mugiq_smoke_", dir=here)
    try:
        mom = os.path.join(tmp, "moms.txt")
        with open(mom, "w") as f:
            f.write(MG_FLAGSHIP_MOMENTA)
        argv = with_flagship_gauge(MG_FLAGSHIP_ARGS) + ["--momenta-filename",
                                                         mom]
        res = run_mesh("mg mesh --mesh 2 1 (gloo)", "2 1",
                       [("block-hops", "block-hops", argv),
                        ("loop", "loop", argv)], "gloo", timeout=900)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    hop_err = check_block_hops("mg mesh 2 1 Galerkin hops", res["block-hops"])
    got = res["loop"]
    ref = mg_flagship
    for r, d in enumerate(got):
        name = f"mg mesh 2 1 rank {r}"
        check_mg_flagship(name, _Ranked(d))
        ev = float(np.max(np.abs(d["evals"] - ref.evals) / ref.evals))
        dm = float(np.max(np.abs(d["data_mom"] - ref.data_mom))
                   / np.max(np.abs(ref.data_mom)))
        lk, h = d["launches"], d["halo"]
        mg = {k: v for k, v in d["phases"].items()
              if k.startswith("mg-") or k in ("eigensolve", "solution",
                                               "operator-setup")}
        say(f"{name}/{int(d['world'])}: wall {float(d['wall']):.2f} s, "
            f"phases {json.dumps(mg)}, restarts {int(d['n_restarts'])} "
            f"(rank 0 {int(got[0]['n_restarts'])}, one device "
            f"{ref.n_restarts}), coarse evals rel {ev:.2e} of the one-device "
            f"run (tol 1e-4), data_mom rel {dm:.2e} (tol 1e-3); launches "
            f"K7a {lk['wilson_m_halo']}, K5 {lk['dslash_hop_dir']}, K2 "
            f"{lk['loop_contract']}, K3 {lk['covariant_displace']}, K1 "
            f"{lk['wilson_m']}; halo {h['bytes'] / 1e9:.3f} GB sent in "
            f"{h['exchanges']} exchanges, {h['seconds']:.2f} s host time in "
            f"the exchange calls")
        if not (ev <= 1e-4 and dm <= 1e-3
                and int(d["n_restarts"]) == int(got[0]["n_restarts"])):
            raise AssertionError(f"{name} disagrees with the one-device MG "
                                 f"flagship or with rank 0")
        for k in ("wilson_m_halo", "dslash_hop_dir", "loop_contract",
                  "covariant_displace"):
            if lk[k] <= 0:
                raise AssertionError(f"{name}: {k} not launched")
        if lk["wilson_m"]:
            raise AssertionError(f"{name}: launched K1")
    return hop_err


def fine_loop_ulocal(env, evecs, weights, geom, momenta, ft_sign=-1):
    """The coarse-space ultra-local loop's fine factorized form
    (tests/test_coarse_loop.py) from the prolongated eigenvectors psi_m =
    P u_m, on their device in complex128:
    L_n(p, t) = sum_m w_m sum_ij gcoeff(n)_ij <psi_m, unit_i>
    <phase_p delta_t unit_j, psi_m>; numpy [P, 16, T]."""
    import numpy as np
    import torch
    from mugiq_tpu_torch.mg.coarse_loop import _gcoeff_np, _phase_np

    c128 = torch.complex128
    dev = evecs.device
    psi = env.prolongate(evecs).to(c128)          # [m, T, Z, Y, X, 4, 3]
    m, T = psi.shape[:2]
    psi = psi.reshape(m, T, -1, 12)
    A = psi.conj().sum(dim=(1, 2))                # [m, 12]
    ph = torch.as_tensor(np.stack(
        [np.array(_phase_np(geom, p, ft_sign)[0]).reshape(-1)
         for p in momenta], -1), dtype=c128, device=dev)     # [V, P]
    B = torch.einsum("mtvj,vp->mptj", psi, ph.conj())
    del psi
    gco = torch.as_tensor(_gcoeff_np(), dtype=c128, device=dev)
    w = torch.as_tensor(np.asarray(weights, dtype=np.float64), dtype=c128,
                        device=dev)
    return torch.einsum("nij,mi,mptj,m->pnt", gco, A, B, w).cpu().numpy()


def phase_coarse_loop(counters):
    """The coarse-space ultra-local loop at 32^3x64 through the loop CLI's
    API path (COARSE_LOOP_ARGS): the MG-coarse eigensolve in complex64 to
    max coarse residual <= MG_MAX_RESIDUAL (its tol 1e-6 sits at the
    complex64 floor: it may stop at its 120 restarts short of it), the
    coarse loop
    finite, of shape [P, 16, T], equal to its fine factorized form from
    the prolongated eigenvectors on the card within COARSE_LOOP_TOL of max
    |L|, and every field on the card."""
    import numpy as np
    import torch
    from mugiq_tpu_torch.cli import loop as cli_loop

    mom = os.path.join(WORK["dir"], "coarse_loop_moms.txt")
    with open(mom, "w") as f:
        f.write(MG_FLAGSHIP_MOMENTA)
    argv = with_flagship_gauge(COARSE_LOOP_ARGS) + ["--momenta-filename",
                                                     mom]
    say("coarse loop CLI: python -m mugiq_tpu_torch.cli.loop "
        + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    (result, eig, coarse), wall, phases, _ = run_main_path(
        "coarse loop", cli_loop.run, argv, counters)
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = eig.output
    for i, (lam, r) in enumerate(zip(out.evals, out.resids)):
        say(f"coarse loop: coarse eval[{i}] {lam.real:+.10e} resid {r:.3e}")
    devices = {t.device.type for t in (eig.evecs, result.data_pos,
                                       eig.mg_env.transfers[0].V)}
    momenta = [tuple(int(v) for v in ln.split())
               for ln in MG_FLAGSHIP_MOMENTA.splitlines()]
    t0 = time.perf_counter()
    want = fine_loop_ulocal(eig.mg_env, eig.evecs,
                            1.0 / np.asarray(out.evals).real, eig.geom,
                            momenta)
    t_fine = time.perf_counter() - t0
    err = float(np.abs(coarse - want).max() / np.abs(want).max())
    say(f"coarse loop: wall {wall:.2f} s, restriction and assembly "
        f"(coarse-loop) {phases.get('coarse-loop', float('nan')):.3f} s, "
        f"fine factorized form {t_fine:.3f} s; converged={out.converged} "
        f"restarts={out.n_restarts} max coarse resid {out.resids.max():.3e}"
        f" (limit {MG_MAX_RESIDUAL:.0e}); shape {coarse.shape}, |L|_max "
        f"{np.abs(coarse).max():.6e}, vs the fine form rel {err:.2e} (tol "
        f"{COARSE_LOOP_TOL:.0e}); fields on {sorted(devices)}; peak device "
        f"memory {peak:.1f} GB")
    if not out.resids.max() <= MG_MAX_RESIDUAL:
        raise AssertionError("coarse loop: the coarse eigensolve's "
                             "residual is over its limit")
    if coarse.shape != (len(momenta), 16, 64) or not np.isfinite(
            coarse).all():
        raise AssertionError(f"coarse loop: shape {coarse.shape} or not "
                             f"finite")
    if not err <= COARSE_LOOP_TOL:
        raise AssertionError("coarse loop disagrees with its fine form")
    if devices != {"cuda"}:
        raise AssertionError(f"coarse loop: fields left the card: "
                             f"{devices}")


def stoch_sums(data, names=("1", "g5")):
    """The volume sums of the complex traces [2, 16, T, Z, Y, X] for the
    named gammas (float64 on the device), as complex numbers."""
    from mugiq_tpu_torch.gamma import GAMMA_NAMES
    out = []
    for g in names:
        k = GAMMA_NAMES.index(g)
        re = float(data[0, k].double().sum())
        im = float(data[1, k].double().sum())
        out.append(complex(re, im))
    return out


def phase_stoch_flagship(dev, counters, launches):
    """The deflated stochastic trace at 32^3x64 (STOCH_*: the recipe of
    the JAX package's scripts/stoch32.py on the flagship gauge): the
    MdagM eigensolve, the deflation space (M v_n through K1), then the 4
    noises one call each (seeds 99 + i), deflated and plain, each CG on
    M^dag M through K1 and each contraction through K2; every CG
    residual <= STOCH_TOL, the estimates finite, K1 and K2 launched
    (counters zeroed before the deflation build, read after the plain
    probes; fills `launches`); the variance over the noises of the
    volume-summed Gamma = 1 and gamma_5 traces, deflated against plain.
    Then at 8^3x16 the same trace through the kernels against the twins
    on the CPU, the card's eigenvectors handed to the CPU."""
    import numpy as np
    import torch
    from mugiq_tpu_torch.io.gauge_io import load_gauge_np
    from mugiq_tpu_torch.lattice import LatticeGeometry
    from mugiq_tpu_torch.params import EigParam, GaugeParam, InvertParam
    from mugiq_tpu_torch.production import (build_kernel_dirac,
                                            compute_evecs_production)
    from mugiq_tpu_torch.stochastic_production import (
        DeflationSpaceKernel, stochastic_loop_trace_production)

    argv = with_flagship_gauge(FLAGSHIP_ARGS)
    dims = tuple(int(v) for v in argv[argv.index("--dims") + 1:][:4])
    geom = LatticeGeometry(dims)
    t0 = time.perf_counter()
    U = load_gauge_np(argv[argv.index("--gauge") + 1], geom)
    gp, ip = GaugeParam(dims=dims), InvertParam(kappa=STOCH_KAPPA)
    say(f"stoch flagship: gauge read in {time.perf_counter() - t0:.1f} s")

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    t0 = synced()
    res, evals, _, rs = compute_evecs_production(
        U, gp, ip, EigParam(**STOCH_EIG), seed=STOCH_EIG_SEED, device=dev)
    t_eig = synced() - t0
    op = build_kernel_dirac(U, gp, ip, device=dev)
    del U
    say(f"stoch flagship: eigensolve {t_eig:.2f} s, restarts "
        f"{res.n_restarts}, converged={res.converged}, max resid "
        f"{max(rs):.3e}, evals {np.round(evals, 6).tolist()}")
    zero_counts(counters)
    t0 = synced()
    defl = DeflationSpaceKernel.build(op, res.evecs, evals)
    t_defl = synced() - t0
    seconds, solves, sums, mean = {}, {}, {}, {}
    for name, ds in (("deflated", defl), ("plain", None)):
        solves[name], sums[name], acc = [], [], None
        t0 = synced()
        for i in range(STOCH_NOISES):
            d = stochastic_loop_trace_production(
                op, geom, 1, deflation=ds, solver_tol=STOCH_TOL,
                seed=STOCH_SEED + i, solves=solves[name])
            sums[name].append(stoch_sums(d))
            acc = d if acc is None else acc.add_(d)
            del d
        seconds[name] = synced() - t0
        mean[name] = acc / STOCH_NOISES
        del acc
    lk = read_counts(counters)
    launches.update({k: lk[k] for k in ("wilson_m", "loop_contract")})
    finite = all(bool(torch.isfinite(m).all()) for m in mean.values())
    say(f"stoch flagship: deflation build {t_defl:.3f} s, deflated probes "
        f"{seconds['deflated']:.3f} s, plain probes {seconds['plain']:.3f} s"
        f" ({STOCH_NOISES} noises each, one call a noise); launches K1 "
        f"{lk['wilson_m']}, K2 {lk['loop_contract']}; estimates finite: "
        f"{finite} ({card_line()})")
    for name in solves:
        say(f"stoch flagship {name}: CG iterations "
            f"{[it for it, _ in solves[name]]}, residuals "
            f"{[f'{r:.2e}' for _, r in solves[name]]}")
        for k, g in enumerate(("1", "g5")):
            x = np.asarray([s[k] for s in sums[name]])
            say(f"stoch flagship {name}: volume-summed Tr[Gamma={g} M^-1] "
                f"per noise {[f'{v.real:+.6e}{v.imag:+.6e}j' for v in x]}, "
                f"mean {x.mean().real:+.6e}{x.mean().imag:+.6e}j, variance "
                f"{float(np.mean(np.abs(x - x.mean()) ** 2)):.6e}")
    del mean, defl, res, op
    torch.cuda.empty_cache()
    worst = max(r for v in solves.values() for _, r in v)
    if not (worst <= STOCH_TOL and finite):
        raise AssertionError(f"stoch flagship: CG residual {worst:.2e} > "
                             f"{STOCH_TOL:.0e} or estimates not finite")
    if lk["wilson_m"] <= 0 or lk["loop_contract"] <= 0:
        raise AssertionError(f"stoch flagship: K1 or K2 not launched: {lk}")

    # 8^3x16: the kernels against the twins on the same eigenvectors
    geom = LatticeGeometry(STOCH_TWIN_DIMS)
    U = load_gauge_np("random", geom, seed=1)
    gp = GaugeParam(dims=STOCH_TWIN_DIMS)
    res, evals, _, rs = compute_evecs_production(
        U, gp, ip, EigParam(**STOCH_EIG), seed=STOCH_EIG_SEED, device=dev)
    data, its = {}, {}
    for name, d in (("kernels", dev), ("twins", "cpu")):
        op = build_kernel_dirac(U, gp, ip, device=d)
        its[name] = []
        t0 = time.perf_counter()
        data[name] = stochastic_loop_trace_production(
            op, geom, STOCH_TWIN_NOISES,
            deflation=DeflationSpaceKernel.build(op, res.evecs.to(d), evals),
            solver_tol=STOCH_TOL, seed=STOCH_SEED, solves=its[name]).cpu()
        say(f"stoch 8^3x16 via {name} on {d}: "
            f"{time.perf_counter() - t0:.2f} s, CG iterations "
            f"{[it for it, _ in its[name]]}, residuals "
            f"{[f'{r:.2e}' for _, r in its[name]]}")
    a, b = data["kernels"], data["twins"]
    err = float((a - b).abs().max() / b.abs().max())
    say(f"stoch 8^3x16 kernels vs twins: rel {err:.2e} (tol "
        f"{STOCH_TWIN_TOL:.0e}); eigensolve restarts {res.n_restarts}, max "
        f"resid {max(rs):.2e}")
    if not (err <= STOCH_TWIN_TOL and bool(torch.isfinite(a).all())):
        raise AssertionError("stoch 8^3x16 through the kernels disagrees "
                             "with the twins")


def phase_halo(dev, stats):
    """K7a, K4-halo and K7b against their twins on the card at the 32^3x64
    shapes of rank 0 of a 2 1 and a 2 2 2 grid, every variant; the
    interior and boundary launches; every rank's block tied to K1 / K4 /
    K6."""
    import torch
    from mugiq_tpu_torch.kernels.parity import (parity_hop, parity_hop_halo,
                                                parity_hop_halo_plain)
    from mugiq_tpu_torch.kernels.wilson import (FLOP_PER_SITE, dslash_hop,
                                                dslash_hop_halo,
                                                dslash_hop_halo_plain,
                                                wilson_m, wilson_m_halo,
                                                wilson_m_halo_plain)
    from mugiq_tpu_torch.parallel.mesh import LatticeMesh
    from mugiq_tpu_torch.schur_kernel import pack_parity, pack_parity_gauge

    T, Z, Y, X = KERNEL_SHAPE
    dims = (X, Y, Z, T)
    kappa = 0.12
    g = torch.Generator(device=dev).manual_seed(4)
    psi = torch.randn((T, 24, Z, Y * X), generator=g, device=dev)
    U = torch.randn((T, 4, 18, Z, Y * X), generator=g, device=dev) * 0.5
    A = torch.randn((T, 144, Z, Y * X), generator=g, device=dev) * 0.2
    Ut = torch.roll(U[:, 3], 1, 0)

    def k7a_inputs(m, prec):
        dt = torch.float32 if prec == "f32" else torch.bfloat16
        ze, ye = m.z_ext, m.y_ext
        return (m.ext_block(psi, t=True, z=ze, y=ye),
                m.ext_block(U.to(dt), t=False, z=ze, y=ye),
                m.ext_block(Ut.to(dt), t=False, z=ze, y=ye),
                m.local_block(A.to(dt)).contiguous())

    worst = (0.0, 0.0)
    for mesh in ((2, 1), (2, 2, 2)):
        m = LatticeMesh(mesh, dims, rank=0, device=dev)
        ze, ye, Yl, Tl = m.z_ext, m.y_ext, m.local["y"], m.local["t"]
        sites = Tl * m.local["z"] * Yl * X
        tag = " ".join(map(str, mesh))
        for prec in ("f32", "bf16"):
            pe, Ue, Ute, Al = k7a_inputs(m, prec)
            out = None
            for clover in (False, True):
                for dagger in (False, True):
                    A144 = Al if clover else None
                    ref = wilson_m_halo_plain(pe, Ue, Ute, A144, kappa,
                                              dagger, Yl, ze, ye)
                    got = wilson_m_halo(pe, Ue, Ute, A144, kappa, dagger, Yl,
                                        ze, ye)
                    err, rel = compare("wilson_m_halo", got, ref)
                    worst = max(worst, (rel, err))
                    del ref
                    out = torch.empty_like(got)

                    def run(rows=None):
                        return wilson_m_halo(pe, Ue, Ute, A144, kappa, dagger,
                                             Yl, ze, ye, rows=rows, out=out)

                    ms = cuda_ms(run, 20)
                    pms = cuda_ms(lambda: wilson_m_halo_plain(
                        pe, Ue, Ute, A144, kappa, dagger, Yl, ze, ye), 3, 1)
                    # least traffic: the extended spinor, the extended links
                    # and t-links, clover, the output, each once
                    moved = nbytes(pe, Ue, Ute, A144, got)
                    b = bound(moved, (FLOP_PER_SITE + (576 if clover else 0))
                              * sites)
                    say(f"K7a wilson_m_halo mesh {tag} rank 0 {prec} "
                        f"clover={int(clover)} dagger={int(dagger)}: rel err "
                        f"{rel:.2e} (abs {err:.2e}, tol "
                        f"{TOL['wilson_m_halo']:.0e})  kernel {ms:.3f} ms "
                        f"(bound {b['bound_ms']:.3f} ms by {b['bound_by']}, "
                        f"{b['bound_ms'] / ms:.2f} of it)  twin {pms:.3f} ms")
                    if (mesh, prec, clover, dagger) == ((2, 1), "f32", False,
                                                        False):
                        stats["wilson_m_halo"] = {"ms": ms, "plain_ms": pms,
                                                  "library_ms": None, **b}
                        ims = cuda_ms(lambda: run((1, Tl - 2, 1)), 20)
                        bms = cuda_ms(lambda: run((0, 2, Tl - 1)), 20)
                        say(f"K7a mesh {tag} rank 0 f32 Wilson M: interior "
                            f"launch (rows 1..{Tl - 2}) {ims:.3f} ms, "
                            f"boundary launch (rows 0, {Tl - 1}) {bms:.3f} ms, "
                            f"single pass {ms:.3f} ms")
                    del got
            del pe, Ue, Ute, Al, out
            torch.cuda.empty_cache()
    stats["wilson_m_halo"]["max_abs_err"] = worst[1]

    # K4-halo (the bare hop of the block): every link type and dagger at
    # both rank shapes, the interior / boundary split bit for bit, every
    # rank's block tied to K4 on the global field
    worst = (0.0, 0.0)
    for mesh in ((2, 1), (2, 2, 2)):
        m = LatticeMesh(mesh, dims, rank=0, device=dev)
        ze, ye, Yl, Tl = m.z_ext, m.y_ext, m.local["y"], m.local["t"]
        sites = Tl * m.local["z"] * Yl * X
        tag = " ".join(map(str, mesh))
        for prec in ("f32", "bf16"):
            pe, Ue, Ute, _ = k7a_inputs(m, prec)
            for dagger in (False, True):
                args = (pe, Ue, Ute, dagger, Yl, ze, ye)
                ref = dslash_hop_halo_plain(*args)
                got = dslash_hop_halo(*args)
                err, rel = compare("dslash_hop_halo", got, ref)
                worst = max(worst, (rel, err))
                del ref
                split = torch.full_like(got, float("nan"))
                dslash_hop_halo(*args, rows=(1, Tl - 2, 1), out=split)
                dslash_hop_halo(*args, rows=(0, 2, Tl - 1), out=split)
                if not torch.equal(split, got):
                    raise AssertionError("K4-halo: the interior / boundary "
                                         "launches differ from the single "
                                         "pass")
                out = torch.empty_like(got)
                ms = cuda_ms(lambda: dslash_hop_halo(*args, out=out), 20)
                moved = nbytes(pe, Ue, Ute, got)
                b = bound(moved, FLOP_PER_SITE * sites)
                say(f"K4-halo dslash_hop_halo mesh {tag} rank 0 {prec} "
                    f"dagger={int(dagger)}: rel err {rel:.2e} (abs "
                    f"{err:.2e}, tol {TOL['dslash_hop_halo']:.0e}), split "
                    f"bit-identical  kernel {ms:.3f} ms (bound "
                    f"{b['bound_ms']:.3f} ms by {b['bound_by']}, "
                    f"{b['bound_ms'] / ms:.2f} of it)")
                if (mesh, prec, dagger) == ((2, 1), "f32", False):
                    pms = cuda_ms(lambda: dslash_hop_halo_plain(*args), 3, 1)
                    ims = cuda_ms(lambda: dslash_hop_halo(
                        *args, rows=(1, Tl - 2, 1), out=out), 20)
                    bms = cuda_ms(lambda: dslash_hop_halo(
                        *args, rows=(0, 2, Tl - 1), out=out), 20)
                    say(f"K4-halo mesh {tag} rank 0 f32 D: twin {pms:.3f} ms;"
                        f" interior launch {ims:.3f} ms, boundary launch "
                        f"{bms:.3f} ms, single pass {ms:.3f} ms")
                    stats["dslash_hop_halo"] = {"ms": ms, "plain_ms": pms,
                                                "library_ms": None, **b}
                del got, out, split
            del pe, Ue, Ute
            torch.cuda.empty_cache()
    stats["dslash_hop_halo"]["max_abs_err"] = worst[1]
    for mesh in ((2, 1), (2, 2, 2)):
        for dagger in (False, True):
            ref = dslash_hop(psi, U, dagger, Y)
            got = torch.empty_like(ref)
            for r in range(LatticeMesh(mesh, dims).world):
                m = LatticeMesh(mesh, dims, rank=r, device=dev)
                ext = dict(z=m.z_ext, y=m.y_ext)
                m.local_block(got)[...] = dslash_hop_halo(
                    m.ext_block(psi, t=True, **ext),
                    m.ext_block(U, t=False, **ext),
                    m.ext_block(Ut, t=False, **ext), dagger, m.local["y"],
                    m.z_ext, m.y_ext)
            _, rel = compare("slab", got, ref)
            say(f"slab tie K4-halo (mesh {' '.join(map(str, mesh))}, every "
                f"rank) vs K4, dagger={int(dagger)}: rel {rel:.2e} (tol "
                f"{TOL['slab']:.0e})")
            del ref, got

    # every rank's K7a block concatenated equals K1 on the global field
    for mesh in ((2, 1), (2, 2, 2)):
        for dagger in (False, True):
            ref = wilson_m(psi, U, A, kappa, dagger, Y)
            got = torch.empty_like(ref)
            for r in range(LatticeMesh(mesh, dims).world):
                m = LatticeMesh(mesh, dims, rank=r, device=dev)
                pe, Ue, Ute, Al = (m.ext_block(psi, t=True, z=m.z_ext,
                                               y=m.y_ext),
                                   m.ext_block(U, t=False, z=m.z_ext,
                                               y=m.y_ext),
                                   m.ext_block(Ut, t=False, z=m.z_ext,
                                               y=m.y_ext),
                                   m.local_block(A).contiguous())
                m.local_block(got)[...] = wilson_m_halo(
                    pe, Ue, Ute, Al, kappa, dagger, m.local["y"], m.z_ext,
                    m.y_ext)
            _, rel = compare("slab", got, ref)
            say(f"slab tie K7a (mesh {' '.join(map(str, mesh))}, every "
                f"rank) vs K1, clover dagger={int(dagger)}: rel {rel:.2e} "
                f"(tol {TOL['slab']:.0e})")
            del ref, got
    del psi, A
    torch.cuda.empty_cache()

    # K7b on packed fields of the same lattice
    Xh = X // 2
    pin_field = torch.randn((T, 24, Z, Y * Xh), generator=g, device=dev)
    pout = torch.randn((T, 24, Z, Y * Xh), generator=g, device=dev)
    Ap = torch.randn((T, 144, Z, Y * Xh), generator=g, device=dev) * 0.2
    k2 = kappa ** 2
    worst = (0.0, 0.0)
    for mesh in ((2, 1), (2, 2, 2)):
        m = LatticeMesh(mesh, dims, rank=0, device=dev)
        ze, ye, Yl, Tl = m.z_ext, m.y_ext, m.local["y"], m.local["t"]
        sites = Tl * m.local["z"] * Yl * Xh
        tag = " ".join(map(str, mesh))
        pe = m.ext_block(pin_field, t=True, z=ze, y=ye)
        po_loc = m.local_block(pout).contiguous()
        for prec, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            Al = m.local_block(Ap.to(dt)).contiguous()
            variants = (("pass1", 1, {}), ("pass1+A_post", 1, dict(A_post=Al)),
                        ("pass2", 0, dict(kappa2=k2, psi_out=po_loc)),
                        ("pass2+A_comb", 0, dict(kappa2=k2, psi_out=po_loc,
                                                 A_comb=Al)))
            for vtag, po, kw in variants:
                Uo = pack_parity_gauge(U.to(dt), Y, po)
                Ui = pack_parity_gauge(U.to(dt), Y, 1 - po)
                Uoe = m.ext_block(Uo, t=False, z=ze, y=ye)
                Uie = m.ext_block(Ui, t=False, z=ze, y=ye)
                Ute = m.ext_block(torch.roll(Ui[:, 3], 1, 0), t=False, z=ze,
                                  y=ye)
                del Uo, Ui
                for dagger in (False, True):
                    args = (pe, Uoe, Uie, Ute, Yl, po, dagger, ze, ye)
                    ref = parity_hop_halo_plain(*args, **kw)
                    got = parity_hop_halo(*args, **kw)
                    err, rel = compare("parity_hop_halo", got, ref)
                    worst = max(worst, (rel, err))
                    del ref
                    out = torch.empty_like(got)
                    ms = cuda_ms(lambda: parity_hop_halo(*args, out=out,
                                                         **kw), 20)
                    pms = cuda_ms(lambda: parity_hop_halo_plain(*args, **kw),
                                  3, 1)
                    clover = "A_post" in kw or "A_comb" in kw
                    moved = nbytes(pe, Uoe, Uie, Ute, got, kw.get("psi_out"),
                                   kw.get("A_post"), kw.get("A_comb"))
                    b = bound(moved, (FLOP_PER_SITE + (576 if clover else 0))
                              * sites)
                    say(f"K7b parity_hop_halo mesh {tag} rank 0 {prec} {vtag} "
                        f"dagger={int(dagger)}: rel err {rel:.2e} (abs "
                        f"{err:.2e}, tol {TOL['parity_hop_halo']:.0e})  "
                        f"kernel {ms:.3f} ms (bound {b['bound_ms']:.3f} ms "
                        f"by {b['bound_by']}, {b['bound_ms'] / ms:.2f} of "
                        f"it)  twin {pms:.3f} ms")
                    if (mesh, prec, vtag, dagger) == ((2, 1), "f32", "pass1",
                                                      False):
                        stats["parity_hop_halo"] = {
                            "ms": ms, "plain_ms": pms, "library_ms": None,
                            **b}
                    del got, out
                del Uoe, Uie, Ute
                torch.cuda.empty_cache()
        del pe
    stats["parity_hop_halo"]["max_abs_err"] = worst[1]

    # every rank's K7b block concatenated equals K6 on the global field
    A_glob = Ap
    for mesh in ((2, 1), (2, 2, 2)):
        for vtag, po, kw in (("pass1+A_post", 1, dict(A_post=A_glob)),
                             ("pass2+A_comb", 0, dict(kappa2=k2, psi_out=pout,
                                                      A_comb=A_glob))):
            Uo, Ui = pack_parity_gauge(U, Y, po), pack_parity_gauge(U, Y,
                                                                    1 - po)
            Uti = torch.roll(Ui[:, 3], 1, 0)
            for dagger in (False, True):
                ref = parity_hop(pin_field, Uo, Ui, Y, po, dagger, **kw)
                got = torch.empty_like(ref)
                for r in range(LatticeMesh(mesh, dims).world):
                    m = LatticeMesh(mesh, dims, rank=r, device=dev)
                    ext = dict(z=m.z_ext, y=m.y_ext)
                    loc = {k: (m.local_block(v).contiguous()
                               if torch.is_tensor(v) else v)
                           for k, v in kw.items()}
                    m.local_block(got)[...] = parity_hop_halo(
                        m.ext_block(pin_field, t=True, **ext),
                        m.ext_block(Uo, t=False, **ext),
                        m.ext_block(Ui, t=False, **ext),
                        m.ext_block(Uti, t=False, **ext), m.local["y"], po,
                        dagger, m.z_ext, m.y_ext, **loc)
                _, rel = compare("slab", got, ref)
                say(f"slab tie K7b (mesh {' '.join(map(str, mesh))}, every "
                    f"rank) vs K6, {vtag} dagger={int(dagger)}: rel "
                    f"{rel:.2e} (tol {TOL['slab']:.0e})")
                del ref, got
            del Uo, Ui, Uti
            torch.cuda.empty_cache()
    del pin_field, pout, Ap, U, Ut
    torch.cuda.empty_cache()
    halo_bf16_psi(dev, stats)


def halo_bf16_psi(dev, stats):
    """The bf16-spinor forms of K7a (M, M^dag; Wilson, clover), K4-halo (D,
    D^dag) and K7b (its four passes, both daggers), with f32 and bf16
    links, at the 32^3x64 rank-0 block of a 2 1 grid: each against its
    twin within 2^-7 of max |out| (a bf16 output), the interior/boundary
    launches equal to the single pass, timed with its bound and share;
    both ranks' blocks against the bf16-spinor K1, K4 and K6 on the
    global field.  Adds the forms bf16_psi (f32 links) and all_bf16 to the
    kernels' entries."""
    import torch
    from mugiq_tpu_torch.kernels.parity import (parity_hop, parity_hop_halo,
                                                parity_hop_halo_plain)
    from mugiq_tpu_torch.kernels.wilson import (FLOP_PER_SITE, dslash_hop,
                                                dslash_hop_halo,
                                                dslash_hop_halo_plain,
                                                wilson_m, wilson_m_halo,
                                                wilson_m_halo_plain)
    from mugiq_tpu_torch.parallel.mesh import LatticeMesh
    from mugiq_tpu_torch.schur_kernel import pack_parity_gauge

    T, Z, Y, X = KERNEL_SHAPE
    dims = (X, Y, Z, T)
    Xh = X // 2
    kappa, k2 = 0.12, 0.12 ** 2
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(9)
    psi = torch.randn((T, 24, Z, Y * X), generator=g, device=dev).to(bf)
    U32 = torch.randn((T, 4, 18, Z, Y * X), generator=g, device=dev) * 0.5
    A32 = torch.randn((T, 144, Z, Y * X), generator=g, device=dev) * 0.2
    pin = torch.randn((T, 24, Z, Y * Xh), generator=g, device=dev).to(bf)
    pout = torch.randn((T, 24, Z, Y * Xh), generator=g, device=dev).to(bf)
    Ap32 = torch.randn((T, 144, Z, Y * Xh), generator=g, device=dev) * 0.2
    m = LatticeMesh((2, 1), dims, rank=0, device=dev)
    Tl = m.local["t"]
    sites = Tl * Z * Y * X
    forms = {k: stats.setdefault("forms", {}).setdefault(k, {})
             for k in ("wilson_m_halo", "dslash_hop_halo", "parity_hop_halo")}
    worst = {k: 0.0 for k in forms}

    def check(kern, tag, fn, plain, moved, flops, key):
        """fn(rows=, out=) against plain(), its split, its time (kept as
        the form `key` unless None)."""
        ref = plain()
        got = fn()
        if got.dtype != bf:
            raise AssertionError(f"{kern} {tag}: out {got.dtype}, not bf16")
        err, rel = compare(f"{kern}_bf16", got, ref)
        worst[kern] = max(worst[kern], err)
        split = torch.full_like(got, float("nan"))
        fn(rows=(1, Tl - 2, 1), out=split)
        fn(rows=(0, 2, Tl - 1), out=split)
        if not torch.equal(split, got):
            raise AssertionError(f"{kern} {tag}: the interior / boundary "
                                 f"launches differ from the single pass")
        out = torch.empty_like(got)
        del ref, got, split
        _time_forms(kern, f"mesh 2 1 rank 0 {tag}", lambda: fn(out=out),
                    plain, moved + nbytes(out), flops, forms[kern], key,
                    f"; rel err vs twin {rel:.2e} (tol 2^-7), split "
                    f"bit-identical")
        if key is not None:
            forms[kern][key]["source"] = BF16_PSI_SOURCE[kern, key]

    for prec, dt in (("f32", torch.float32), ("bf16", bf)):
        key = "bf16_psi" if prec == "f32" else "all_bf16"
        U, A = U32.to(dt), A32.to(dt)
        Ut = torch.roll(U[:, 3], 1, 0)
        pe = m.ext_block(psi, t=True)
        Ue, Ute = m.ext_block(U, t=False), m.ext_block(Ut, t=False)
        Al = m.local_block(A).contiguous()
        for clover in (False, True):
            for dagger in (False, True):
                A144 = Al if clover else None
                check("wilson_m_halo", f"bf16 spinors, {prec} links, clover="
                      f"{int(clover)} dagger={int(dagger)}",
                      lambda **k: wilson_m_halo(pe, Ue, Ute, A144, kappa,
                                                dagger, Y, False, False, **k),
                      lambda: wilson_m_halo_plain(pe, Ue, Ute, A144, kappa,
                                                  dagger, Y, False, False),
                      nbytes(pe, Ue, Ute, A144),
                      (FLOP_PER_SITE + (576 if clover else 0)) * sites,
                      key if not (clover or dagger) else None)
        for dagger in (False, True):
            check("dslash_hop_halo", f"bf16 spinors, {prec} links, "
                  f"dagger={int(dagger)}",
                  lambda **k: dslash_hop_halo(pe, Ue, Ute, dagger, Y, False,
                                              False, **k),
                  lambda: dslash_hop_halo_plain(pe, Ue, Ute, dagger, Y, False,
                                                False),
                  nbytes(pe, Ue, Ute), FLOP_PER_SITE * sites,
                  key if not dagger else None)
        # every rank's block against the global bf16-spinor K1 and K4
        for dagger in (False, True):
            for kern, glob, blk in (
                    ("K7a", lambda: wilson_m(psi, U, A, kappa, dagger, Y),
                     lambda r, a: wilson_m_halo(*a, r.local_block(A)
                                                .contiguous(), kappa, dagger,
                                                Y, False, False)),
                    ("K4-halo", lambda: dslash_hop(psi, U, dagger, Y),
                     lambda r, a: dslash_hop_halo(*a, dagger, Y, False,
                                                  False))):
                ref = glob()
                got = torch.empty_like(ref)
                for r in range(2):
                    mr = LatticeMesh((2, 1), dims, rank=r, device=dev)
                    mr.local_block(got)[...] = blk(mr, (
                        mr.ext_block(psi, t=True), mr.ext_block(U, t=False),
                        mr.ext_block(Ut, t=False)))
                err, rel = compare("slab_bf16", got, ref)
                say(f"slab tie {kern} bf16 spinors, {prec} links (mesh 2 1, "
                    f"both ranks) vs {'K1 clover' if kern == 'K7a' else 'K4'}"
                    f" bf16 spinors, dagger={int(dagger)}: rel {rel:.2e} "
                    f"(tol 2^-7), max abs diff {err:.1e}")
                del ref, got
        del pe, Ue, Ute, Al

        # K7b on the packed fields
        Ap = Ap32.to(dt)
        pe = m.ext_block(pin, t=True)
        po_loc = m.local_block(pout).contiguous()
        Al = m.local_block(Ap).contiguous()
        for vtag, po, kw in (("pass1", 1, {}),
                             ("pass1+A_post", 1, dict(A_post=Al)),
                             ("pass2", 0, dict(kappa2=k2, psi_out=po_loc)),
                             ("pass2+A_comb", 0, dict(kappa2=k2,
                                                      psi_out=po_loc,
                                                      A_comb=Al))):
            Uo, Ui = pack_parity_gauge(U, Y, po), pack_parity_gauge(U, Y,
                                                                    1 - po)
            Uti = torch.roll(Ui[:, 3], 1, 0)
            Uoe, Uie = m.ext_block(Uo, t=False), m.ext_block(Ui, t=False)
            Ute = m.ext_block(Uti, t=False)
            clover = "A_post" in kw or "A_comb" in kw
            for dagger in (False, True):
                args = (pe, Uoe, Uie, Ute, Y, po, dagger, False, False)
                check("parity_hop_halo", f"bf16 spinors, {prec} links, "
                      f"{vtag} dagger={int(dagger)}",
                      lambda **k: parity_hop_halo(*args, **kw, **k),
                      lambda: parity_hop_halo_plain(*args, **kw),
                      nbytes(pe, Uoe, Uie, Ute, kw.get("psi_out"),
                             kw.get("A_post"), kw.get("A_comb")),
                      (FLOP_PER_SITE + (576 if clover else 0)) * Tl * Z * Y
                      * Xh, key if (vtag, dagger) == ("pass1", False)
                      else None)
            if vtag in ("pass1+A_post", "pass2+A_comb"):
                gkw = {k: (pout if k == "psi_out" else Ap if
                           torch.is_tensor(v) else v) for k, v in kw.items()}
                for dagger in (False, True):
                    ref = parity_hop(pin, Uo, Ui, Y, po, dagger, **gkw)
                    got = torch.empty_like(ref)
                    for r in range(2):
                        mr = LatticeMesh((2, 1), dims, rank=r, device=dev)
                        loc = {k: (mr.local_block(v).contiguous()
                                   if torch.is_tensor(v) else v)
                               for k, v in gkw.items()}
                        mr.local_block(got)[...] = parity_hop_halo(
                            mr.ext_block(pin, t=True),
                            mr.ext_block(Uo, t=False),
                            mr.ext_block(Ui, t=False),
                            mr.ext_block(Uti, t=False), Y, po, dagger, False,
                            False, **loc)
                    _, rel = compare("slab_bf16", got, ref)
                    say(f"slab tie K7b bf16 spinors, {prec} links (mesh 2 1, "
                        f"both ranks) vs K6 bf16 spinors, {vtag} dagger="
                        f"{int(dagger)}: rel {rel:.2e} (tol 2^-7)")
                    del ref, got
            del Uo, Ui, Uti, Uoe, Uie, Ute
        del pe, po_loc, Al, U, A, Ut, Ap
        torch.cuda.empty_cache()
    halo_bf16_pairs(dev, psi, U32, A32, kappa, forms, worst)
    for k, f in forms.items():
        f["bf16_psi_max_abs_err"] = worst[k]


def halo_bf16_pairs(dev, psi, U32, A32, kappa, forms, worst):
    """K7a's and K4-halo's bf16-spinor pair instances of the z and y halo
    forms (rank 0 of 2 2 and 2 2 2 at 32^3x64) against their twins, the
    split bit for bit; then the one-site bf16 instance, forced by a base
    two bytes off a four-byte boundary, at the 2 1 rank-0 block, against
    its twin and timed beside the pair form (forms' one_site_ms)."""
    import torch
    from mugiq_tpu_torch.kernels.wilson import (FLOP_PER_SITE, aligned_pairs,
                                                dslash_hop_halo,
                                                dslash_hop_halo_plain,
                                                launch_plan, wilson_m_halo,
                                                wilson_m_halo_plain)
    from mugiq_tpu_torch.parallel.mesh import LatticeMesh

    T, Z, Y, X = KERNEL_SHAPE
    dims = (X, Y, Z, T)
    bf = torch.bfloat16

    def held(kern, tag, fn, plain, Tl):
        """fn(rows=, out=) against plain() and its split; the abs error."""
        got = fn()
        err, rel = compare(f"{kern}_bf16", got, plain())
        split = torch.full_like(got, float("nan"))
        fn(rows=(1, Tl - 2, 1), out=split)
        fn(rows=(0, 2, Tl - 1), out=split)
        if not torch.equal(split, got):
            raise AssertionError(f"{kern} {tag}: the interior / boundary "
                                 f"launches differ from the single pass")
        say(f"{kern} {tag}: rel err vs twin {rel:.2e} (tol 2^-7), split "
            f"bit-identical")
        worst[kern] = max(worst[kern], err)
        return got

    for mesh in ((2, 2), (2, 2, 2)):
        m = LatticeMesh(mesh, dims, rank=0, device=dev)
        ze, ye, Yl, Tl = m.z_ext, m.y_ext, m.local["y"], m.local["t"]
        ext = dict(z=ze, y=ye)
        tag = " ".join(map(str, mesh))
        for prec, dt in (("f32", torch.float32), ("bf16", bf)):
            U = U32.to(dt)
            pe = m.ext_block(psi, t=True, **ext)
            Ue = m.ext_block(U, t=False, **ext)
            Ute = m.ext_block(torch.roll(U[:, 3], 1, 0), t=False, **ext)
            Al = m.local_block(A32.to(dt)).contiguous()
            for kern in ("wilson_m_halo", "dslash_hop_halo"):
                if not launch_plan(kern, 1, X, True,
                                   aligned_pairs(pe, Ue, Ute, Al)).pair:
                    raise AssertionError(f"{kern}: mesh {tag} not paired")
            for dagger in (False, True):
                for A144 in (None, Al):
                    held("wilson_m_halo", f"pairs mesh {tag} rank 0 bf16 "
                         f"spinors, {prec} links, clover="
                         f"{int(A144 is not None)} dagger={int(dagger)}",
                         lambda **k: wilson_m_halo(pe, Ue, Ute, A144, kappa,
                                                   dagger, Yl, ze, ye, **k),
                         lambda: wilson_m_halo_plain(pe, Ue, Ute, A144, kappa,
                                                     dagger, Yl, ze, ye), Tl)
                held("dslash_hop_halo", f"pairs mesh {tag} rank 0 bf16 "
                     f"spinors, {prec} links, dagger={int(dagger)}",
                     lambda **k: dslash_hop_halo(pe, Ue, Ute, dagger, Yl, ze,
                                                 ye, **k),
                     lambda: dslash_hop_halo_plain(pe, Ue, Ute, dagger, Yl,
                                                   ze, ye), Tl)
            del U, pe, Ue, Ute, Al
            torch.cuda.empty_cache()

    m = LatticeMesh((2, 1), dims, rank=0, device=dev)
    Tl = m.local["t"]
    sites = Tl * Z * Y * X
    pe = misaligned(m.ext_block(psi, t=True))
    for prec, dt in (("f32", torch.float32), ("bf16", bf)):
        key = "bf16_psi" if prec == "f32" else "all_bf16"
        U = U32.to(dt)
        Ue = m.ext_block(U, t=False)
        Ute = m.ext_block(torch.roll(U[:, 3], 1, 0), t=False)
        Al = m.local_block(A32.to(dt)).contiguous()
        # (kernel, form, its wrapper and twin, operands, timed)
        for kern, tag, fn, plain, args, timed in (
                ("wilson_m_halo", "Wilson M", wilson_m_halo,
                 wilson_m_halo_plain,
                 (pe, Ue, Ute, None, kappa, False, Y, False, False), True),
                ("wilson_m_halo", "clover M^dag", wilson_m_halo,
                 wilson_m_halo_plain,
                 (pe, Ue, Ute, Al, kappa, True, Y, False, False), False),
                ("dslash_hop_halo", "D", dslash_hop_halo,
                 dslash_hop_halo_plain,
                 (pe, Ue, Ute, False, Y, False, False), True)):
            plan = launch_plan(kern, 1, X, True, aligned_pairs(pe, Ue, Ute))
            if plan.pair:
                raise AssertionError(f"{kern}: a misaligned base planned as "
                                     f"pairs")
            got = held(kern, f"one site a thread ({plan.source}.cu, "
                       f"misaligned base) mesh 2 1 rank 0 bf16 spinors, "
                       f"{prec} links, {tag}",
                       lambda **k: fn(*args, **k), lambda: plain(*args), Tl)
            if timed:
                out = torch.empty_like(got)
                ms = cuda_ms(lambda: fn(*args, out=out), 20)
                b = bound(nbytes(pe, Ue, Ute, out), FLOP_PER_SITE * sites)
                forms[kern][key]["one_site_ms"] = ms
                say(f"{kern} bf16 spinors, {prec} links, {tag}, one site a "
                    f"thread, mesh 2 1 rank 0: kernel {ms:.3f} ms (bound "
                    f"{b['bound_ms']:.3f} ms, {b['bound_ms'] / ms:.2f} of "
                    f"it); two sites a thread {forms[kern][key]['ms']:.3f} "
                    f"ms")
                del out
            del got
        del U, Ue, Ute, Al


def keep_pos_run(argv):
    """The loop CLI's flags through production.compute_loop_production
    with keep_pos (no CLI flag asks for it), on the mesh the flags ask
    for; returns the ProductionResult (data_pos global on every rank)."""
    from mugiq_tpu_torch.cli import loop as cli_loop
    from mugiq_tpu_torch.cli.common import (build_mesh, build_params,
                                            read_momenta_file)
    from mugiq_tpu_torch.io.gauge_io import load_gauge_np
    from mugiq_tpu_torch.lattice import LatticeGeometry
    from mugiq_tpu_torch.params import LoopParam
    from mugiq_tpu_torch.production import compute_loop_production

    args = cli_loop.parse_args(argv)
    gp, ip, ep = build_params(args)
    mesh, dev = build_mesh(args, gp.dims)
    U = load_gauge_np(args.gauge, LatticeGeometry(gp.dims),
                      seed=args.gauge_seed)
    lp = LoopParam(momenta=read_momenta_file(args.momenta_filename),
                   do_nonlocal=True,
                   disp_entries=args.displace_entry_string.split(";"))
    return compute_loop_production(U, gp, ip, ep, lp, keep_pos=True,
                                   mesh=mesh, seed=ep.seed, device=dev)


def evec_round_trip(out, name, argv, evecs, evals):
    """parallel.distributed.save_evecs_sharded then load_evecs_sharded of
    this rank's evecs (OUT/evecs_<name>.proc<r>.npz) on the mesh of the
    eigensolve CLI's flags argv: (bitwise, the file's keys)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from mugiq_tpu_torch.cli import eigensolve as cli_eig
    from mugiq_tpu_torch.cli.common import build_params
    from mugiq_tpu_torch.parallel.distributed import (load_evecs_sharded,
                                                      save_evecs_sharded)
    from mugiq_tpu_torch.parallel.mesh import LatticeMesh

    args = cli_eig.parse_args(argv)
    mesh = LatticeMesh(args.mesh, build_params(args)[0].dims,
                       rank=dist.get_rank(), device=evecs.device)
    prefix = os.path.join(out, f"evecs_{name}")
    path = save_evecs_sharded(prefix, evecs, evals, mesh)
    back, ev = load_evecs_sharded(prefix, mesh, device=evecs.device)
    with np.load(path) as z:
        keys = sorted(z.files)
    return (bool(torch.equal(back, evecs))
            and bool(np.array_equal(ev, np.asarray(evals)))), keys


def mesh_worker(out, spec):
    """One rank of run_mesh's launch: run each job's CLI as a main path
    and write the rank's results to OUT/<job>.rank<r>.npz ("loop-pos":
    keep_pos_run, its data_pos; a "pc" job also round-trips its evecs
    through the per-rank npz files)."""
    import numpy as np
    import torch.distributed as dist
    from pathlib import Path

    from mugiq_tpu_torch.cli import eigensolve as cli_eig
    from mugiq_tpu_torch.cli import loop as cli_loop
    from mugiq_tpu_torch.parallel import halo
    from mugiq_tpu_torch.parallel.distributed import shutdown_distributed

    counters = kernel_counters()
    for job in json.loads(Path(spec).read_text()):
        if job["mode"] in ("hop", "block-hops"):
            check = (sharded_hop_check if job["mode"] == "hop"
                     else block_hops_check)
            res = check(job["argv"], counters)  # starts the group
            np.savez(Path(out) / f"{job['name']}.rank{dist.get_rank()}.npz",
                     **res)
            continue
        loop = job["mode"] in ("loop", "loop-pos")
        halo.reset_totals()
        run = {"loop": cli_loop.run, "eig": cli_eig.run,
               "arnoldi": arnoldi_run, "loop-pos": keep_pos_run}[job["mode"]]
        got, wall, phases, launches = run_main_path(job["name"], run,
                                                    job["argv"], counters)
        extra = {}
        if loop:
            res, data_mom = got, got.data_mom
            evals, sigma, resids = res.evals, res.sigma, res.resids
            if res.data_pos is not None:
                extra["data_pos"] = res.data_pos
        else:
            res, evals, sigma, resids = got
            data_mom = np.zeros(0)
            if job["name"] == "pc":
                extra["evec_round_trip"], extra["evec_keys"] = \
                    evec_round_trip(out, job["name"], job["argv"],
                                    res.evecs, evals)
        np.savez(Path(out) / f"{job['name']}.rank{dist.get_rank()}.npz",
                 evals=np.asarray(evals), sigma=np.asarray(sigma),
                 resids=np.asarray(resids), data_mom=data_mom,
                 n_restarts=res.n_restarts, converged=res.converged,
                 wall=wall, phases=json.dumps(phases),
                 launches=json.dumps(launches),
                 halo=json.dumps(halo.TOTALS), backend=dist.get_backend(),
                 world=dist.get_world_size(), **extra)
    shutdown_distributed()


def sharded_hop_check(argv, counters):
    """One rank of the sharded bare hop: ShardedWilsonKernel._hop and
    _hop_dag (K4-halo over the halo exchange) on the rank's block of a
    seeded field and of its bf16 rounding (K4-halo's bf16-spinor form),
    with every launch counter zeroed just before and read just after;
    then each held to K4's plain twin (errs) and to K4 (ties) on the
    global field (f32, then bf16)."""
    import torch
    from mugiq_tpu_torch.cli import loop as cli_loop
    from mugiq_tpu_torch.cli.common import build_mesh, build_params
    from mugiq_tpu_torch.io.gauge_io import load_gauge_np
    from mugiq_tpu_torch.kernels.wilson import dslash_hop, dslash_hop_plain
    from mugiq_tpu_torch.lattice import LatticeGeometry
    from mugiq_tpu_torch.parallel.shard_op import ShardedWilsonKernel
    from mugiq_tpu_torch.production import build_kernel_dirac

    args = cli_loop.parse_args(argv)
    gp, ip, _ = build_params(args)
    mesh, dev = build_mesh(args, gp.dims)
    U = load_gauge_np(args.gauge, LatticeGeometry(gp.dims),
                      seed=args.gauge_seed)
    single = build_kernel_dirac(U, gp, ip, device=dev)
    op = ShardedWilsonKernel.from_kernel_op(mesh, single)
    g = torch.Generator(device=dev).manual_seed(6)
    psi = torch.randn(single.field_shape, generator=g, device=dev)
    fields = (psi, psi.bfloat16())
    locs = [op.place(f) for f in fields]
    zero_counts(counters)
    got = [h(loc) for loc in locs for h in (op._hop, op._hop_dag)]
    torch.cuda.synchronize()
    launches = read_counts(counters)
    errs, ties = [], []
    for i, h in enumerate(got):
        f_psi, dagger = fields[i // 2], bool(i % 2)
        for acc, f in ((errs, dslash_hop_plain), (ties, dslash_hop)):
            want = mesh.local_block(f(f_psi, single.U_k, dagger, single.Y))
            if h.dtype != want.dtype:
                raise AssertionError(f"sharded hop: out {h.dtype}, K4 "
                                     f"{want.dtype}")
            acc.append(float((h.float() - want.float()).abs().max()
                             / want.float().abs().max()))
            del want
    del got, single, op
    torch.cuda.empty_cache()
    return {"errs": errs, "ties": ties, "launches": json.dumps(launches),
            "world": mesh.world}


def block_hops_check(argv, counters):
    """One rank of the MG Galerkin's hops (kernel_mg.block_hops: K5 on the
    rank's block, and along a partitioned axis on the probe and links
    extended one slice a side, the interior kept), as MGEnvRC.build calls
    them under the mesh: the sharded operator's block links upcast to
    f32, a seeded f32 probe's block, every (mu, sign), with every launch
    counter zeroed just before and read just after; each hop held to K5's
    plain twin on the global field, the rank's block of it (errs: rel to
    its max; abs: max abs)."""
    import torch
    from mugiq_tpu_torch.cli import loop as cli_loop
    from mugiq_tpu_torch.cli.common import build_mesh, build_params
    from mugiq_tpu_torch.io.gauge_io import load_gauge_np
    from mugiq_tpu_torch.kernels.hop_dir import dslash_hop_dir_plain
    from mugiq_tpu_torch.lattice import LatticeGeometry
    from mugiq_tpu_torch.mg.kernel_mg import block_hops
    from mugiq_tpu_torch.parallel.shard_op import ShardedWilsonKernel
    from mugiq_tpu_torch.production import build_kernel_dirac

    args = cli_loop.parse_args(argv)
    gp, ip, _ = build_params(args)
    mesh, dev = build_mesh(args, gp.dims)
    U = load_gauge_np(args.gauge, LatticeGeometry(gp.dims),
                      seed=args.gauge_seed)
    single = build_kernel_dirac(U, gp, ip, precision=args.link_precision,
                                device=dev)
    op = ShardedWilsonKernel.from_kernel_op(mesh, single)
    g = torch.Generator(device=dev).manual_seed(7)
    psi = torch.randn(single.field_shape, generator=g, device=dev)
    p = mesh.local_block(psi)
    zero_counts(counters)
    hops = block_hops(mesh, op.halo, op.block_links().float())
    got = [hops(p, mu) for mu in range(4)]
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    launches = read_counts(counters)
    del hops, op
    U32 = single.U_k.float()
    errs, abs_errs = [], []
    for mu in range(4):
        for h, sign in zip(got[mu], (1, -1)):
            want = mesh.local_block(dslash_hop_dir_plain(psi, U32, mu, sign,
                                                         False, single.Y))
            if h.shape != want.shape:
                raise AssertionError(f"block hops: out {tuple(h.shape)}, "
                                     f"the block {tuple(want.shape)}")
            err = float((h - want).abs().max())
            abs_errs.append(err)
            errs.append(err / float(want.abs().max()))
            del want
    del got, single, U32
    if on_card:
        torch.cuda.empty_cache()
    return {"errs": errs, "abs": abs_errs, "launches": json.dumps(launches),
            "world": mesh.world, "block": list(p.shape)}


def check_block_hops(name, ranks):
    """Every rank's MG Galerkin hops (block_hops_check), the eight (mu,
    sign), within TOL['dslash_hop_dir'] of K5's plain twin on the global
    field, eight K5 launches and no other; returns the largest abs
    error."""
    for r, d in enumerate(ranks):
        errs = [float(e) for e in d["errs"]]
        lk = d["launches"]
        say(f"{name} rank {r}/{int(d['world'])}: K5 on the block "
            f"{[int(v) for v in d['block']]} (+/-x..+/-t) rel "
            f"{' '.join(f'{e:.2e}' for e in errs)} vs its twin on the "
            f"global field (tol {TOL['dslash_hop_dir']:.0e}), max abs "
            f"{max(float(e) for e in d['abs']):.2e}; launches K5 "
            f"{lk['dslash_hop_dir']}, others "
            f"{sum(v for k, v in lk.items() if k != 'dslash_hop_dir')}")
        if max(errs) > TOL["dslash_hop_dir"]:
            raise AssertionError(f"{name} rank {r}: the Galerkin's hops "
                                 f"disagree with K5's twin")
        if lk["dslash_hop_dir"] != 8 or any(
                v for k, v in lk.items() if k != "dslash_hop_dir"):
            raise AssertionError(f"{name} rank {r}: launches {lk}")
    return max(float(e) for d in ranks for e in d["abs"])


def check_sharded_hop(name, ranks):
    """Every rank's sharded bare hop, f32 then bf16 spinors, within
    TOL['dslash_hop_halo'] (bf16: TOL['dslash_hop_halo_bf16']) of K4's
    plain twin and within TOL['slab'] (TOL['slab_bf16']) of K4 on the
    global field, each application one interior and one boundary K4-halo
    launch and no K4; returns rank 0's K4-halo launches, all and
    bf16-spinor."""
    for r, d in enumerate(ranks):
        errs = [float(e) for e in d["errs"]]
        ties = [float(e) for e in d["ties"]]
        lk = d["launches"]
        say(f"{name} rank {r}/{int(d['world'])}: f32 D, D^dag rel "
            f"{errs[0]:.2e}, {errs[1]:.2e} vs K4's twin on the global field "
            f"(tol {TOL['dslash_hop_halo']:.0e}), vs K4 {ties[0]:.2e}, "
            f"{ties[1]:.2e} (tol {TOL['slab']:.0e}); bf16 D, D^dag rel "
            f"{errs[2]:.2e}, {errs[3]:.2e} vs the twin, {ties[2]:.2e}, "
            f"{ties[3]:.2e} vs K4 (tol 2^-7); launches K4-halo "
            f"{lk['dslash_hop_halo']} ({lk['dslash_hop_halo.bf16']} bf16), "
            f"K4 {lk['dslash_hop']}")
        if max(errs[:2]) > TOL["dslash_hop_halo"] or \
                max(errs[2:]) > TOL["dslash_hop_halo_bf16"]:
            raise AssertionError(f"{name} rank {r}: the sharded hop "
                                 f"disagrees with K4's twin")
        if max(ties[:2]) > TOL["slab"] or max(ties[2:]) > TOL["slab_bf16"]:
            raise AssertionError(f"{name} rank {r}: the sharded hop "
                                 f"disagrees with K4")
        if lk["dslash_hop_halo"] != 8 or lk["dslash_hop_halo.bf16"] != 4 \
                or lk["dslash_hop"] or lk["wilson_m_halo"]:
            raise AssertionError(f"{name} rank {r}: launches {lk}")
    lk = ranks[0]["launches"]
    return lk["dslash_hop_halo"], lk["dslash_hop_halo.bf16"]


def run_mesh(name, mesh, jobs, backend, timeout=900):
    """Launch one sharded run: `python -m torch.distributed.run` with one
    process per rank of `mesh`, each running mesh_worker on `jobs` [(job,
    mode, argv)]; returns {job: [per-rank results]}.  Fails if any rank
    fails."""
    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    n = 1
    for v in mesh.split():
        n *= int(v)
    tmp = tempfile.mkdtemp(prefix="mugiq_mesh_", dir=here)
    try:
        spec = os.path.join(tmp, "jobs.json")
        with open(spec, "w") as f:
            json.dump([{"name": j, "mode": mode,
                        "argv": argv + ["--mesh", *mesh.split(),
                                        "--dist-backend", backend]}
                       for j, mode, argv in jobs], f)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(n), os.path.abspath(__file__),
               "--mesh-worker", tmp, spec]
        say(f"{name}: {n} rank(s), {backend}: " + " ".join(cmd[1:6])
            + " chip_smoke.py --mesh-worker ...")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=here, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=timeout)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            say(proc.stdout[-8000:])
            raise AssertionError(f"{name}: a rank failed (launcher rc "
                                 f"{proc.returncode})")
        say(f"{name}: launcher wall {wall:.2f} s")
        out = {}
        for j, _, _ in jobs:
            out[j] = []
            for r in range(n):
                with np.load(os.path.join(tmp, f"{j}.rank{r}.npz")) as z:
                    d = {k: z[k] for k in z.files}
                for k in ("phases", "launches", "halo"):
                    if k in d:
                        d[k] = json.loads(str(d[k]))
                out[j].append(d)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_ranks(name, ranks, ref, mom_tol, launched, not_launched,
                bf16_basis=False):
    """Every rank against the single-device reference `ref` (evals,
    data_mom or None, restarts): converged, the same restarts, evals 1e-5
    relative, data_mom mom_tol of max, residuals under MAX_RESIDUAL; the
    path's kernels launched on every rank, the single-device stencils
    not.  bf16_basis: the basis rounds after sums in another order than
    on one device, so the ranks are held to its eigenvalues (1e-3
    relative), not to its restarts or convergence, residuals under 0.1
    (the JAX bound), data_mom finite."""
    import numpy as np
    evals, data_mom, restarts = ref
    ev_tol = 1e-3 if bf16_basis else 1e-5
    max_resid = 0.1 if bf16_basis else MAX_RESIDUAL
    for r, d in enumerate(ranks):
        ev = match_rel(d["evals"], evals)
        msg = (f"{name} rank {r}: converged={bool(d['converged'])} restarts "
               f"{int(d['n_restarts'])} (single device {restarts}), evals rel "
               f"{ev:.2e} (tol {ev_tol:.0e}), max resid "
               f"{float(d['resids'].max()):.2e} (tol {max_resid:.0e})")
        ok = ev <= ev_tol and float(d["resids"].max()) < max_resid
        if not bf16_basis:
            ok = ok and (bool(d["converged"])
                         and int(d["n_restarts"]) == restarts)
        if bf16_basis and data_mom is not None:
            fin = bool(np.isfinite(d["data_mom"]).all())
            msg += f", data_mom finite: {fin}"
            ok = ok and fin
        elif data_mom is not None:
            dm = float(np.max(np.abs(d["data_mom"] - data_mom))
                       / np.max(np.abs(data_mom)))
            msg += f", data_mom rel {dm:.2e} (tol {mom_tol:.0e})"
            ok = ok and dm <= mom_tol
        if r == 0:
            msg += (f"; wall {float(d['wall']):.2f} s, phases "
                    f"{json.dumps(d['phases'])}")
        say(msg)
        if not ok:
            raise AssertionError(f"{name} rank {r} disagrees with the single "
                                 f"device")
        for k in launched:
            if d["launches"][k] <= 0:
                raise AssertionError(f"{name} rank {r}: {k} not launched")
        for k in not_launched:
            if d["launches"][k] != 0:
                raise AssertionError(f"{name} rank {r}: launched {k}")


def phase_mesh_slice(counters):
    """The 8^3x16 loop over --mesh 2 2 2 and the pc eigensolve over --mesh
    2 1 (ranks sharing the card: gloo), f32 and with a bf16 basis, held to
    the same runs on one device, each launch preceded by the sharded bare
    hop of its ranks held to K4; returns K7b's launches on rank 0 of the
    pc run, its bf16-spinor launches on rank 0 of the bf16-basis pc run,
    and K4-halo's (all, bf16-spinor) on rank 0 of the 2 1 bare hop."""
    from mugiq_tpu_torch.cli import eigensolve as cli_eig
    from mugiq_tpu_torch.cli import loop as cli_loop

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="mugiq_smoke_", dir=here)
    try:
        mom = os.path.join(tmp, "moms.txt")
        with open(mom, "w") as f:
            f.write(FLAGSHIP_MOMENTA)
        loop_args = SLICE_ARGS + ["--momenta-filename", mom]
        r, _, _, _ = run_main_path("mesh slice, one device", cli_loop.run,
                                   loop_args, counters)
        ref_loop = (r.evals, r.data_mom, r.n_restarts)
        (r, ev, _, _), _, _, _ = run_main_path(
            "mesh pc slice, one device", cli_eig.run, PC_SLICE_ARGS, counters)
        ref_pc = (ev, None, r.n_restarts)
        (r, ev, _, _), _, _, _ = run_main_path(
            "mesh pc slice bf16 basis, one device", cli_eig.run,
            PC_SLICE_BF16_ARGS, counters)
        ref_pc_bf16 = (ev, None, r.n_restarts)
        got = run_mesh("mesh slice loop --mesh 2 2 2", "2 2 2",
                       [("hop", "hop", loop_args),
                        ("loop", "loop", loop_args)], "gloo")
        check_sharded_hop("mesh slice bare hop 2 2 2", got["hop"])
        check_ranks("mesh slice loop 2 2 2", got["loop"], ref_loop, 1e-3,
                    ("wilson_m_halo", "loop_contract", "covariant_displace"),
                    ("wilson_m",))
        block_args = PC_SLICE_ARGS + ["--eig-block-size", "4"]
        (r, ev, _, _), _, _, _ = run_main_path(
            "mesh block slice, one device", cli_eig.run, block_args,
            counters)
        ref_block = (ev, None, r.n_restarts)
        (r, ev, _, _), _, _, _ = run_main_path(
            "mesh arnoldi slice, one device", arnoldi_run, ARNOLDI_SLICE_ARGS,
            counters)
        ref_arnoldi = (ev, None, r.n_restarts)
        ref_pos, _, _, _ = run_main_path("mesh slice keep_pos, one device",
                                         keep_pos_run, loop_args, counters)
        got = run_mesh("mesh slice pc --mesh 2 1", "2 1",
                       [("hop", "hop", loop_args),
                        ("pc", "eig", PC_SLICE_ARGS),
                        ("pc-bf16", "eig", PC_SLICE_BF16_ARGS),
                        ("block", "eig", block_args),
                        ("arnoldi", "arnoldi", ARNOLDI_SLICE_ARGS),
                        ("loop-pos", "loop-pos", loop_args)], "gloo")
        hop_launches = check_sharded_hop("mesh slice bare hop 2 1",
                                         got["hop"])
        check_ranks("mesh slice pc 2 1", got["pc"], ref_pc, 1e-3,
                    ("parity_hop_halo",), ("parity_hop", "wilson_m"))
        check_ranks("mesh slice pc bf16 basis 2 1", got["pc-bf16"],
                    ref_pc_bf16, None,
                    ("parity_hop_halo", "parity_hop_halo.bf16"),
                    ("parity_hop", "wilson_m"), bf16_basis=True)
        check_ranks("mesh slice block (b=4) pc 2 1", got["block"], ref_block,
                    1e-3, ("parity_hop_halo",), ("parity_hop", "wilson_m"))
        check_ranks("mesh slice arnoldi M 2 1", got["arnoldi"], ref_arnoldi,
                    1e-3, ("wilson_m_halo",), ("wilson_m",))
        check_ranks("mesh slice keep_pos loop 2 1", got["loop-pos"],
                    (ref_pos.evals, ref_pos.data_mom, ref_pos.n_restarts),
                    1e-3, ("wilson_m_halo", "loop_contract",
                           "covariant_displace"), ("wilson_m",))
        check_keep_pos_and_evecs(got, ref_pos.data_pos)
        return (got["pc"][0]["launches"]["parity_hop_halo"],
                got["pc-bf16"][0]["launches"]["parity_hop_halo.bf16"],
                hop_launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_keep_pos_and_evecs(got, want):
    """mesh-slice's 2 1 launch: every rank's keep_pos data_pos (the global
    position-space loops) within 1e-3 of max of the one-device run's (the
    sharded loop's data_mom tolerance), and the pc job's evecs back bit
    for bit through the per-rank npz files, under the JAX package's keys.
    The GPU machine has no h5py, so the per-rank position-space files are
    checked by the CPU tests only."""
    import numpy as np
    for r, d in enumerate(got["loop-pos"]):
        err = float(np.abs(d["data_pos"] - want).max() / np.abs(want).max())
        say(f"mesh slice keep_pos 2 1 rank {r}: data_pos {d['data_pos'].shape}"
            f" vs one device rel {err:.2e} (tol 1e-3)")
        if d["data_pos"].shape != want.shape or not err <= 1e-3:
            raise AssertionError(f"mesh slice keep_pos rank {r} disagrees "
                                 f"with one device")
    for r, d in enumerate(got["pc"]):
        keys = [str(k) for k in d["evec_keys"]]
        say(f"mesh slice evec npz 2 1 rank {r}: round trip bitwise "
            f"{bool(d['evec_round_trip'])}, keys {keys}")
        if not (bool(d["evec_round_trip"])
                and keys == ["evals", "global_shape", "index0", "shard0"]):
            raise AssertionError(f"mesh slice evec npz rank {r}")


def phase_mesh_flagship(flagship, counters):
    """The 32^3x64 loop flagship through the CLI over --mesh 1 1 (one rank,
    NCCL) and --mesh 2 1 (two ranks: gloo on a one-card machine; NCCL too
    where there are two cards), held to the single-device flagship, each
    2 1 launch preceded by the sharded bare hop of its ranks; then, in the
    same launch, with bf16 links and a bf16 basis, BF16_MESH_RESTARTS
    restarts, held to that configuration on one device (evals 1e-3,
    residuals < 0.1) and to the f32 flagship (evals 3e-2).  Returns K7a's
    launches of the one-rank f32 run, its bf16-spinor launches of the
    one-rank bf16 run, and K4-halo's (all, bf16-spinor) on rank 0 of the
    2 1 gloo bare hop."""
    import numpy as np
    import torch

    ref = (flagship.evals, flagship.data_mom, flagship.n_restarts)
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="mugiq_smoke_", dir=here)
    meshes = [("1 1", "nccl")]
    if torch.cuda.device_count() >= 2:
        meshes.append(("2 1", "nccl"))
    else:
        say(f"mesh flagship: NCCL between separate cards not exercised "
            f"({torch.cuda.device_count()} card); two ranks share the card "
            f"over gloo")
    meshes.append(("2 1", "gloo"))
    launches = bf16_launches = hop_launches = None
    try:
        mom = os.path.join(tmp, "moms.txt")
        with open(mom, "w") as f:
            f.write(FLAGSHIP_MOMENTA)
        argv = with_flagship_gauge(FLAGSHIP_ARGS) + ["--momenta-filename",
                                                      mom]
        bf16_argv = argv + BF16_MESH_FLAGS
        ref_bf16 = phase_flagship_variant(
            "bf16 links + bf16 basis flagship, one device", BF16_MESH_FLAGS,
            counters, flagship, 3e-2, 0.1)[0]
        ref_bf16 = (ref_bf16.evals, ref_bf16.data_mom, ref_bf16.n_restarts)
        for mesh, backend in meshes:
            name = f"mesh flagship --mesh {mesh} ({backend})"
            # one launch a mesh: the f32 and the bf16 loop run in the same
            # ranks, one after the other
            jobs = [("loop", "loop", argv), ("loop-bf16", "loop", bf16_argv)]
            if mesh == "2 1":
                jobs.insert(0, ("hop", "hop", argv))
            res = run_mesh(name, mesh, jobs, backend, timeout=1200)
            if mesh == "2 1":
                n = check_sharded_hop(f"{name} bare hop", res["hop"])
                if backend == "gloo":
                    hop_launches = n
            for job, bf16 in (("loop", False), ("loop-bf16", True)):
                got = res[job]
                run = name + (" bf16 links + bf16 basis" if bf16 else "")
                if bf16:
                    check_ranks(run, got, ref_bf16, None,
                                ("wilson_m_halo", "wilson_m_halo.bf16",
                                 "loop_contract", "covariant_displace"),
                                ("wilson_m",), bf16_basis=True)
                    for r, d in enumerate(got):
                        ev = match_rel(d["evals"], flagship.evals)
                        say(f"{run} rank {r}: evals rel {ev:.2e} of the f32 "
                            f"flagship's (tol 3e-2)")
                        if ev > 3e-2:
                            raise AssertionError(f"{run} rank {r}: evals off "
                                                 f"the f32 flagship's")
                else:
                    check_ranks(run, got, ref, 1e-3,
                                ("wilson_m_halo", "loop_contract",
                                 "covariant_displace"), ("wilson_m",))
                for r, d in enumerate(got):
                    k7a = d["launches"]["wilson_m_halo"]
                    apps = k7a // 2      # interior + boundary per application
                    h = d["halo"]
                    say(f"{run} rank {r}/{int(d['world'])}: backend "
                        f"{d['backend']}, wall {float(d['wall']):.2f} s, "
                        f"phases {json.dumps(d['phases'])}, restarts "
                        f"{int(d['n_restarts'])}, K7a launches {k7a} "
                        f"({d['launches']['wilson_m_halo.bf16']} bf16 "
                        f"spinors; {apps} applications), halo "
                        f"{h['bytes'] / 1e9:.3f} GB sent in "
                        f"{h['exchanges']} exchanges "
                        f"({h['bytes'] / max(apps, 1) / 1e6:.3f} MB per "
                        f"application), {h['seconds']:.2f} s host time in "
                        f"the exchange calls")
                if mesh == "1 1":
                    if bf16:
                        bf16_launches = \
                            got[0]["launches"]["wilson_m_halo.bf16"]
                    else:
                        launches = got[0]["launches"]["wilson_m_halo"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, bf16_launches, hop_launches


def zero_counts(counters):
    """Set every launch count to 0, the halo kernels' bf16-spinor counts
    too."""
    for k in counters:
        k.launches = 0
        if hasattr(k, "bf16_launches"):
            k.bf16_launches = 0


def read_counts(counters):
    """{kernel: launches}, and {kernel.bf16: launches of its bf16-spinor
    form} for the halo kernels (a part of their launches)."""
    out = {k.__name__: k.launches for k in counters}
    out.update({f"{k.__name__}.bf16": k.bf16_launches for k in counters
                if hasattr(k, "bf16_launches")})
    return out


def kernel_counters():
    from mugiq_tpu_torch.kernels.contract import (covariant_displace,
                                                  loop_contract)
    from mugiq_tpu_torch.kernels.hop_dir import dslash_hop_dir
    from mugiq_tpu_torch.kernels.parity import parity_hop, parity_hop_halo
    from mugiq_tpu_torch.kernels.wilson import (dslash_hop, dslash_hop_halo,
                                                wilson_m, wilson_m_halo)
    return [wilson_m, loop_contract, covariant_displace, parity_hop,
            dslash_hop_dir, wilson_m_halo, parity_hop_halo, dslash_hop,
            dslash_hop_halo]


PHASES = ("build", "kernels", "parity", "bf16", "identity", "slice",
          "pc-slice", "bf16-restart", "bf16-slice", "block-slice",
          "arnoldi-slice", "flagship", "bf16-flagship", "block-flagship",
          "pc-flagship", "hopdir", "mg-slice", "mg-flagship", "mg-mesh",
          "coarse-loop",
          "stoch-flagship", "hop", "halo", "mesh-slice", "mesh-flagship",
          "api-slice", "api-fp64")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--mesh-worker", nargs=2, metavar=("OUTDIR", "JOBS"),
                    help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    phases = opts.phases.split(",")
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
    if opts.mesh_worker:
        mesh_worker(*opts.mesh_worker)
        return 0

    counters = kernel_counters()
    dev = torch.device("cuda")
    stats = {}
    launches = {}
    t0 = time.perf_counter()
    WORK["dir"] = tempfile.mkdtemp(prefix="mugiq_smoke_", dir=here)
    try:
        run_phases(phases, dev, counters, stats, launches)
    finally:
        shutil.rmtree(WORK["dir"], ignore_errors=True)
    say(f"chip_smoke: phases {','.join(phases)} passed in "
        f"{time.perf_counter() - t0:.1f} s")
    say(card_line())
    forms = stats.get("forms", {})
    for form, got in stats.get("form_launches", {}).items():
        for k, n in got.items():
            forms.setdefault(k, {})[f"{form}_launches"] = n
    if "restart_s" in stats or stats.get("variant_s"):
        say(json.dumps({"restart_s_per_restart": stats.get("restart_s"),
                        "variant_solution_s": stats.get("variant_s")}))
    say(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE[k],
         "replaces": TPU_KERNEL[k], "launches": launches[k], **stats[k],
         **({"forms": forms[k]} if k in forms else {})}
        for k in TPU_KERNEL if k in stats and k in launches]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(phases, dev, counters, stats, launches):
    import torch
    flagship = mg_flagship = None
    # main-path launches of K1's and K6's bf16-spinor and batched forms,
    # and of K1 and K2 in the stochastic trace
    form_launches = stats.setdefault("form_launches",
                                     {"bf16": {}, "batch4": {},
                                      "bf16_psi": {}, "all_bf16": {},
                                      "stoch": {}})
    stats.setdefault("variant_s", {})
    for phase in phases:
        tp = time.perf_counter()
        if phase == "build":
            phase_build()
        elif phase == "kernels":
            phase_kernels(dev, stats)
        elif phase in ("parity", "hopdir", "halo"):
            if "copy_GBps" not in stats:
                phase_kernels(dev, stats)
            {"parity": phase_parity, "hopdir": phase_hopdir,
             "halo": phase_halo}[phase](dev, stats)
        elif phase == "hop":
            phase_hop(dev, stats, counters, launches)
        elif phase == "bf16":
            phase_bf16(dev, stats)
        elif phase == "identity":
            phase_identity(dev)
        elif phase == "slice":
            phase_slice(dev)
        elif phase == "pc-slice":
            phase_pc_slice(dev)
        elif phase == "bf16-restart":
            phase_bf16_restart(dev, stats)
        elif phase == "bf16-slice":
            phase_bf16_slice(dev, counters, form_launches["bf16"])
        elif phase == "block-slice":
            form_launches["batch4"]["parity_hop"] = phase_block_slice(
                dev, counters)
        elif phase == "arnoldi-slice":
            phase_arnoldi_slice(dev, counters)
        elif phase in ("flagship", "mesh-flagship", "bf16-flagship",
                       "block-flagship"):
            if flagship is None:
                got, flagship = phase_flagship(counters)
                for k in ("wilson_m", "loop_contract", "covariant_displace"):
                    launches[k] = got[k]
            if phase == "bf16-flagship":
                _, t, lk = phase_flagship_variant(
                    "bf16 flagship", ["--basis-precision", "bf16"], counters,
                    flagship, 3e-2, 0.1)
                form_launches["bf16"]["wilson_m"] = lk["wilson_m"]
                stats["variant_s"]["bf16"] = t
            elif phase == "block-flagship":
                _, t, lk = phase_flagship_variant(
                    "block flagship", BLOCK_FLAGSHIP_FLAGS, counters,
                    flagship, 1e-4, MAX_RESIDUAL)
                form_launches["batch4"]["wilson_m"] = lk["wilson_m"]
                stats["variant_s"]["block4"] = t
            elif phase == "mesh-flagship":
                (launches["wilson_m_halo"],
                 form_launches["all_bf16"]["wilson_m_halo"],
                 (launches["dslash_hop_halo"],
                  form_launches["bf16_psi"]["dslash_hop_halo"])) = \
                    phase_mesh_flagship(flagship, counters)
        elif phase == "pc-flagship":
            launches["parity_hop"] = phase_pc_flagship(counters)["parity_hop"]
        elif phase == "mg-slice":
            phase_mg_slice(dev)
        elif phase == "api-slice":
            phase_api_slice()
        elif phase == "coarse-loop":
            phase_coarse_loop(counters)
        elif phase == "stoch-flagship":
            phase_stoch_flagship(dev, counters, form_launches["stoch"])
        elif phase == "api-fp64":
            phase_api_fp64(dev)
        elif phase == "mesh-slice":
            k7b, k7b_bf16, (k4h, k4h_bf16) = phase_mesh_slice(counters)
            launches["parity_hop_halo"] = k7b
            form_launches["bf16_psi"]["parity_hop_halo"] = k7b_bf16
            # the kernels line takes K4-halo's launches from the 32^3x64
            # sharded hop of mesh-flagship, the shape its time is taken at
            launches.setdefault("dslash_hop_halo", k4h)
            form_launches["bf16_psi"].setdefault("dslash_hop_halo",
                                                 k4h_bf16)
        else:
            if mg_flagship is None:
                mg_flagship, got = phase_mg_flagship(counters)
                # the kernels line takes K5's launches from the one-device
                # MG flagship
                launches["dslash_hop_dir"] = got["dslash_hop_dir"]
            if phase == "mg-mesh":
                err = phase_mg_mesh(mg_flagship, counters)
                # K5's max_abs_err: the worst of hopdir's and of the
                # Galerkin's hops at the mg-mesh block
                if "dslash_hop_dir" in stats:
                    k5 = stats["dslash_hop_dir"]
                    k5["max_abs_err"] = max(k5["max_abs_err"], err)
        torch.cuda.empty_cache()
        say(f"phase {phase}: {time.perf_counter() - tp:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
