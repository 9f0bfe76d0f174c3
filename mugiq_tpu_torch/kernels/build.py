"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc for Hopper (sm_90a) into a
shared library with a plain C interface, under ``mugiq_tpu_torch/_build/``
(git-ignored).  The file name carries a hash of every source in ``csrc/``
and of the flags, so an edited source rebuilds and an unchanged one loads
the library already built.  Nothing is built when a module is imported.
The ranks of a sharded run reach their first launch together: the build
runs under a lock file in the build directory, so one process compiles
and the others wait and load its libraries.
"""

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS = {}
_ENTRIES = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the CUDA kernels cannot be built")
    return found


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_source_key()}.so"


def sources() -> list:
    """The kernel sources: the name of every ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


@contextlib.contextmanager
def _build_lock():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


#: each source's nvcc seconds with 8 at once on an 8-core H100 host
#: (chip_smoke.py's build line): the build order, longest first
NVCC_SECONDS = {
    "wilson_m_halo_pair": 89.3, "wilson_m_halo": 53.6,
    "wilson_m_halo_psi_bf16": 53.5, "parity_hop_halo_psi_bf16": 48.8,
    "parity_hop_halo_bf16": 48.1, "parity_hop_halo_all_bf16": 47.4,
    "parity_hop_halo": 45.5, "dslash_hop_halo_pair": 43.1,
    "parity_hop_staged_pair": 33.6, "wilson_m_staged_pair": 33.0,
    "parity_hop": 29.6, "parity_hop_pair": 29.0, "dslash_hop_pair": 28.4,
    "wilson_m_pair": 28.0, "dslash_hop": 25.7,
    "dslash_hop_halo_psi_bf16": 21.7, "dslash_hop_halo": 21.6,
    "parity_hop_staged": 19.6, "wilson_m_staged": 19.0, "wilson_m": 18.6,
    "parity_hop_bf16": 18.0, "wilson_m_bf16": 17.9, "hop_dir": 6.4,
    "contract": 2.4}


def build_order(names) -> list:
    """The order in which the sources compile: longest first (a source
    not in NVCC_SECONDS, not timed yet, before all), so that the last to
    start are short."""
    return sorted(names, key=lambda n: (-NVCC_SECONDS.get(n, float("inf")),
                                        n))


def build_jobs() -> int:
    """How many nvcc processes run at once: one per core this process may
    run on."""
    try:
        return max(len(os.sched_getaffinity(0)), 1)
    except AttributeError:
        return max(os.cpu_count() or 1, 1)


def build_all(names=None) -> None:
    """Compile every ``csrc/<name>.cu`` of `names` (default: all sources)
    not built yet, one nvcc process per source, at most build_jobs() at
    once, in build_order; under the build directory's lock, so concurrent
    processes never run nvcc into it at once."""
    names = sources() if names is None else names
    if all(library_path(n).exists() for n in names):
        return
    with _build_lock():
        _build_missing(names)


def _build_missing(names) -> None:
    jobs = []
    for name in build_order(names):
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs.append((name, so, tmp, cmd))

    def run(job):
        """nvcc on one source: (stdout, stderr, rc, its own seconds)."""
        cmd = job[3]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        return (proc.stdout, proc.stderr, proc.returncode,
                time.perf_counter() - t0)

    # the pool starts the jobs in order, a new one as each ends
    with ThreadPoolExecutor(min(build_jobs(), max(len(jobs), 1))) as pool:
        done = list(pool.map(run, jobs))
    failed = []
    for (name, so, tmp, cmd), (out, err, rc, secs) in zip(jobs, done):
        so.with_suffix(".log").write_text(
            " ".join(cmd) + f"\nnvcc {secs:.1f} s\n" + out + err)
        if rc != 0:
            failed.append(f"nvcc failed building {name}.cu (rc {rc}):\n"
                          f"{err}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and return the loaded library."""
    if name not in _LIBS:
        build_all([name])
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]


def entry(name: str, argtypes):
    """The C entry point ``mugiq_<name>`` of ``csrc/<name>.cu`` (built and
    loaded at first use), with its argument types set and returning the
    launch's cudaError_t."""
    if name not in _ENTRIES:
        fn = getattr(load(name), f"mugiq_{name}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return _ENTRIES[name]


def build_log(name: str) -> str:
    """nvcc's output for the library (ptxas register/spill report)."""
    p = library_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def check(rc: int, what: str):
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def require(t, name: str, shape, dtypes, device):
    """Validate a kernel operand before its pointer goes to C."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype}, expected one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_handle(device) -> int:
    """The current PyTorch stream of `device`, as the C entry points take it."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
