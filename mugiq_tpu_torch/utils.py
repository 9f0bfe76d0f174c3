"""Logging, phase timing and device selection (port of mugiq_tpu.utils).

Phase timers synchronise the CUDA device before each clock read, so a
phase's time is the device work it launched, not the time to enqueue it.
"""

import contextlib
import logging
import os
import time
from collections import defaultdict

import torch

logger = logging.getLogger("mugiq_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[mugiq_tpu_torch] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("MUGIQ_LOG_LEVEL", "INFO"))


def log(msg: str):
    logger.info(msg)


def not_ported(what: str, item: str):
    """Raise for an option whose port is queued: the message names its
    ROADMAP item."""
    raise NotImplementedError(f"{what} is not ported to mugiq_tpu_torch yet "
                              f"(ROADMAP queue 1, {item})")


def pin_full_f32():
    """Full-f32 GEMMs and convolutions: TF32 keeps ~3 decimal digits, which
    floors the Krylov algebra (the JAX eigensolve needed HIGHEST precision
    on every einsum for the same reason, planar/lanczos.py:24-30)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device) -> torch.device:
    """torch.device from a name; a CUDA device without CUDA raises (the
    port never falls back to the CPU quietly)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


#: accumulated per-phase wall-clock, like QUDA's TimeProfile regions
PHASE_TIMES = defaultdict(float)
PHASE_COUNTS = defaultdict(int)


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def phase_timer(name: str):
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        dt = time.perf_counter() - t0
        PHASE_TIMES[name] += dt
        PHASE_COUNTS[name] += 1
        logger.debug(f"phase {name}: {dt:.3f}s")


def print_profile():
    """profile.Print() analog."""
    for name, t in sorted(PHASE_TIMES.items()):
        log(f"PROFILE {name:>20s}: {t:9.3f}s over {PHASE_COUNTS[name]} calls")


def reset_profile():
    PHASE_TIMES.clear()
    PHASE_COUNTS.clear()
