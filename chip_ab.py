#!/usr/bin/env python3
"""A/B of two checkouts of the port on one card, in turns.

    python3 chip_ab.py PARENT_DIR [--phases build,kernels,...] [--out DIR]
                       [--grid-reorder]

Runs PARENT_DIR's chip_smoke.py, then this checkout's twice, then the
parent's again (parent, change, change, parent), each with the same
--phases, one after another on the one card, so that the two versions are
compared within one call and drift shows as the spread of each pair.
With --grid-reorder, a copy of the parent whose K1 and K6 kernels take
the vector as the grid's fastest index (blockIdx.x = site_block * b +
v, so that the vectors of a batch read each link while L2 holds it) runs
as a third side: parent, control, change, change, control, parent.  It
needs a parent whose K1 and K6 put the batch in grid y (wilson_m.cu and
parity_hop.cu each with one kernel and one grid of (site blocks, batch)).
Before its turns the parent's chip_smoke.py is given this checkout's
cuda_ms (a queue of launches per CUDA-event sample): both sides then time
kernels the same way.  Each turn's output goes to DIR/ab_<n>_<side>.log;
the summary prints every kernel-time and solution-time line of the
turns side by side.  PARENT_DIR is a copy of the other commit's files (for
example `git archive <commit> | tar -x -C _archive/parent`).
"""

import argparse
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# lines of chip_smoke.py output the summary keeps: "<key>: ... <value>"
KEEP = [
    (r"^(K1 wilson_m f32 clover=0 dagger=0):.* kernel ([0-9.]+) ms", "ms"),
    (r"^(K6 parity_hop f32 pass1 dagger=0):.* kernel ([0-9.]+) ms", "ms"),
    (r"^(K6 parity_hop f32 pass2 dagger=0):.* kernel ([0-9.]+) ms", "ms"),
    (r"^(K1 wilson_m bf16 spinors, f32 links): kernel ([0-9.]+) ms", "ms"),
    (r"^(K6 parity_hop bf16 spinors, f32 links, pass1): kernel ([0-9.]+) ms",
     "ms"),
    (r"^(K1 wilson_m bf16 spinors, bf16 links): kernel ([0-9.]+) ms", "ms"),
    (r"^(K6 parity_hop bf16 spinors, bf16 links, pass1): kernel ([0-9.]+) ms",
     "ms"),
    (r"^(K1 wilson_m batch 4 \((?:float32|bfloat16) spinors, one launch\)): "
     r"kernel ([0-9.]+) ms", "ms"),
    (r"^(K6 parity_hop batch 4 \((?:float32|bfloat16) spinors, pass1, one "
     r"launch\)): kernel ([0-9.]+) ms", "ms"),
    (r"^(K5 dslash_hop_dir f32 \+x dagger=0):.* kernel ([0-9.]+) ms", "ms"),
    (r"^(K4 dslash_hop psi f32 links f32 out f32 dagger=0):.* kernel "
     r"([0-9.]+) ms", "ms"),
    (r"^(headline K4 hop 32\^3x64 (?:f32|bf16)) \(psi, links, out\): "
     r"([0-9.]+) us", "us"),
    (r"^(K4 dslash_hop psi bf16 links bf16 out bf16 dagger=0):.* kernel "
     r"([0-9.]+) ms", "ms"),
    (r"^(K7a wilson_m_halo mesh 2 1 rank 0 f32 clover=0 dagger=0):.* kernel "
     r"([0-9.]+) ms", "ms"),
    (r"^(K7b parity_hop_halo mesh 2 1 rank 0 f32 pass1 dagger=0):.* kernel "
     r"([0-9.]+) ms", "ms"),
    (r"^(K4-halo dslash_hop_halo mesh 2 1 rank 0 f32 dagger=0):.* kernel "
     r"([0-9.]+) ms", "ms"),
    # the bf16-spinor halo forms (f32 or bf16 links) at the same block
    (r"^(wilson_m_halo mesh 2 1 rank 0 bf16 spinors, (?:f32|bf16) links, "
     r"clover=[01] dagger=0): kernel ([0-9.]+) ms", "ms"),
    (r"^(dslash_hop_halo mesh 2 1 rank 0 bf16 spinors, (?:f32|bf16) links, "
     r"dagger=0): kernel ([0-9.]+) ms", "ms"),
    # the one-site instance of the bf16-spinor forms (a misaligned base)
    (r"^(K4 dslash_hop bf16 spinors, (?:f32|bf16) links, out bf16, one site "
     r"a thread D): kernel ([0-9.]+) ms", "ms"),
    (r"^((?:wilson_m_halo|dslash_hop_halo) bf16 spinors, (?:f32|bf16) links, "
     r"(?:Wilson M|D), one site a thread), mesh 2 1 rank 0: kernel "
     r"([0-9.]+) ms", "ms"),
    (r'^(.*flagship[^:]*): wall .*"solution": ([0-9.]+)\}', "s solution"),
    # rank 0 of each mesh flagship
    (r'^(mesh flagship [^:]*) rank 0/\d+: .*"solution": ([0-9.]+)\}',
     "s solution"),
]


def cuda_ms_source(text):
    """The cuda_ms function and its QUEUE constant of a chip_smoke.py."""
    m = re.search(r"\ndef cuda_ms\(.*?\nQUEUE = \d+\n", text, re.S)
    if m is None:
        raise SystemExit("chip_ab: this chip_smoke.py has no queued cuda_ms")
    return m.group(0)


def give_parent_cuda_ms(parent):
    path = os.path.join(parent, "chip_smoke.py")
    text = open(path).read()
    if "\nQUEUE = " in text:
        return
    mine = cuda_ms_source(open(os.path.join(HERE, "chip_smoke.py")).read())
    old = re.search(r"\ndef cuda_ms\(.*?\n    return ts\[len\(ts\) // 2\]\n",
                    text, re.S)
    if old is None:
        raise SystemExit(f"chip_ab: no cuda_ms in {path}")
    open(path, "w").write(text[:old.start()] + mine + text[old.end():])


def grid_reorder_copy(parent):
    """A copy of the parent beside it whose K1 and K6 kernels run on a
    grid of (site blocks x batch) blocks in one dimension, blockIdx.x =
    site_block * batch + vector, the batch recovered in the kernel as
    gridDim.x over the site blocks."""
    ctl = parent.rstrip("/") + "_grid_reorder"
    if os.path.exists(ctl):
        shutil.rmtree(ctl)
    shutil.copytree(parent, ctl, ignore=shutil.ignore_patterns(
        "_build", "mugiq_smoke_*", "__pycache__"))
    site = "const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;"
    grid = "const dim3 grid((unsigned)((V + 127) / 128), (unsigned)batch);"
    for name in ("wilson_m.cu", "parity_hop.cu"):
        path = os.path.join(ctl, "mugiq_tpu_torch", "kernels", "csrc", name)
        text = open(path).read()
        if (text.count("blockIdx.x") != 1 or text.count(site) != 1
                or text.count(grid) != 1
                or text.count("(long long)blockIdx.y * 24 * S * T") < 1):
            raise SystemExit(f"chip_ab: {path} does not put the batch in "
                             f"grid y; --grid-reorder needs such a parent")
        text = text.replace(site, (
            "const unsigned nb_ = gridDim.x / (unsigned)((S * T + 127) / 128);\n"
            "  const long long i = (long long)(blockIdx.x / nb_) * blockDim.x"
            " + threadIdx.x;"))
        text = text.replace("(long long)blockIdx.y * 24 * S * T",
                            "(long long)(blockIdx.x % nb_) * 24 * S * T")
        text = text.replace(grid, "const dim3 grid((unsigned)((V + 127) / "
                            "128) * (unsigned)batch);")
        open(path, "w").write(text)
    return ctl


def summary(lines):
    got = {}
    for line in lines:
        for pat, unit in KEEP:
            m = re.search(pat, line)
            if m:
                got.setdefault(m.group(1), (m.group(2), unit))
    return got


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("--phases", default="build,kernels,parity,bf16,hopdir,"
                    "hop,halo,flagship,block-flagship,pc-flagship,"
                    "mg-flagship")
    ap.add_argument("--out", default="ab_logs",
                    help="directory for each turn's output (default ab_logs)")
    ap.add_argument("--grid-reorder", action="store_true",
                    help="add the parent with K1's and K6's grid reordered "
                    "(vector fastest) as a third side")
    opts = ap.parse_args(argv)
    parent = os.path.abspath(opts.parent)
    give_parent_cuda_ms(parent)
    out = os.path.abspath(opts.out)
    os.makedirs(out, exist_ok=True)
    turns = [("parent", parent), ("change", HERE), ("change", HERE),
             ("parent", parent)]
    if opts.grid_reorder:
        ctl = grid_reorder_copy(parent)
        turns = [turns[0], ("control", ctl), *turns[1:3], ("control", ctl),
                 turns[3]]
    results = []
    for n, (tag, root) in enumerate(turns):
        log = os.path.join(out, f"ab_{n}_{tag}.log")
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable,
                                 os.path.join(root, "chip_smoke.py"),
                                 "--phases", opts.phases], cwd=root,
                                stdout=f, stderr=subprocess.STDOUT).returncode
        lines = open(log).read().splitlines()
        print(f"turn {n} ({tag}): rc {rc}; {lines[-3] if len(lines) > 2 else ''}",
              flush=True)
        if rc != 0:
            print("\n".join(lines[-20:]))
            return rc
        results.append(summary(lines))
    keys = [k for r in results for k in r]
    print(f"A/B ({', '.join(tag for tag, _ in turns)}):")
    for key in dict.fromkeys(keys):
        vals = [r.get(key, ("-", ""))[0] for r in results]
        unit = next(r[key][1] for r in results if key in r)
        print(f"  {key}: {' / '.join(vals)} {unit}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
