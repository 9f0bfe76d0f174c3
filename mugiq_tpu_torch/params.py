"""Parameter dataclasses (port of mugiq_tpu.params, plus parse_disp_str
from mugiq_tpu.displace).

The same vocabulary as the JAX package: QudaGaugeParam / QudaInvertParam /
QudaEigParam and MugiqLoopParam re-expressed as dataclasses.
"""

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


class DslashType(enum.Enum):
    WILSON = "wilson"
    CLOVER_WILSON = "clover-wilson"


class EigOperator(enum.Enum):
    """Which Dirac matrix to eigensolve (enum_mugiq.h:20-27)."""
    M = "M"
    Mdag = "Mdag"
    MdagM = "MdagM"
    MMdag = "MMdag"


class Spectrum(enum.Enum):
    """Part of spectrum requested (QUDA_SPECTRUM_*)."""
    SR = "SR"  # smallest real
    LR = "LR"  # largest real
    SM = "SM"  # smallest modulus
    LM = "LM"  # largest modulus
    SI = "SI"  # smallest imaginary
    LI = "LI"  # largest imaginary


class MassNormalization(enum.Enum):
    KAPPA = "kappa"
    MASS = "mass"  # QUDA_MASS_NORMALIZATION: rescale by 0.25/kappa^2


class FTSign(enum.IntEnum):
    """Sign of the Fourier-transform exponent (enum_mugiq.h:29-34)."""
    MINUS = -1
    PLUS = 1


class CalcType(enum.Enum):
    """Loop calculation flavour (enum_mugiq.h:36-42); only OPT_KERNEL is
    live, as in the reference."""
    BLAS = "blas"
    OPT_KERNEL = "opt"
    BASIC_KERNEL = "basic"


@dataclass
class GaugeParam:
    dims: Tuple[int, int, int, int]  # (Lx, Ly, Lz, Lt), global
    antiperiodic_t: bool = True      # QUDA_ANTI_PERIODIC_T
    anisotropy: float = 1.0


@dataclass
class InvertParam:
    """Dirac-operator parameters; kappa = 1/(2*(1 + 3/anisotropy + mass))
    (tests/eigensolve.cpp:144-151)."""
    dslash_type: DslashType = DslashType.WILSON
    kappa: Optional[float] = None
    mass: Optional[float] = None
    csw: float = 0.0                 # clover coefficient
    anisotropy: float = 1.0
    mass_normalization: MassNormalization = MassNormalization.KAPPA

    def __post_init__(self):
        if self.kappa is None and self.mass is None:
            raise ValueError("set kappa or mass")
        if self.kappa is None:
            self.kappa = 1.0 / (2.0 * (1.0 + 3.0 / self.anisotropy + self.mass))
        elif self.mass is None:
            self.mass = 0.5 / self.kappa - (1.0 + 3.0 / self.anisotropy)


@dataclass
class EigParam:
    """Eigensolver parameters (mirrors MugiqEigParam, eigsolve_mugiq.h:16-51)."""
    n_ev: int = 16                   # eigenpairs requested (nConv)
    n_kr: int = 48                   # Krylov-space size
    tol: float = 1e-8
    max_restarts: int = 100
    spectrum: Spectrum = Spectrum.SR
    operator: EigOperator = EigOperator.MdagM
    use_poly_acc: bool = False
    poly_deg: int = 0
    a_min: float = 0.0
    a_max: float = 0.0               # 0 -> auto-estimate
    check_interval: int = 1          # restarts between convergence checks
    seed: int = 1234                 # start-vector seed
    block_size: int = 1              # >1: block Lanczos


@dataclass
class MGParam:
    """Multigrid parameters (subset of QudaMultigridParam).

    geo_block_size[lev] aggregates fine dims (x,y,z,t); n_vec[lev] is the
    number of null vectors; spin aggregation on the finest level is chiral
    2-blocking, coarser levels keep 2 spins (tests/eigensolve.cpp:469-492).
    vec_outfile saves the built hierarchy (transfer bases and Galerkin
    stencils); vec_infile loads one instead of running the setup
    (mg_vec_outfile / mg_vec_infile, tests/eigensolve.cpp:584-590).
    """
    n_level: int = 2
    geo_block_size: List[Tuple[int, int, int, int]] = field(
        default_factory=lambda: [(4, 4, 4, 4)])
    n_vec: List[int] = field(default_factory=lambda: [24])
    setup_iters: int = 50            # null-vector smoothing CG iterations
    setup_seed: int = 7
    vec_outfile: str = ""
    vec_infile: str = ""


@dataclass
class LoopParam:
    """Disconnected-loop parameters (mirrors MugiqLoopParam, mugiq.h:28-47)."""
    momenta: Sequence[Tuple[int, int, int]] = field(
        default_factory=lambda: [(0, 0, 0)])
    ft_sign: FTSign = FTSign.MINUS
    calc_type: CalcType = CalcType.OPT_KERNEL
    write_mom_space_hdf5: bool = False
    write_pos_space_hdf5: bool = False
    do_mom_proj: bool = True
    do_nonlocal: bool = False
    disp_entries: List[str] = field(default_factory=list)  # ["+z:1,8", "-x:3"]
    fname_mom_h5: str = ""
    fname_pos_h5: str = ""


_DIRS = {"x": 0, "y": 1, "z": 2, "t": 3}


def parse_disp_str(disp_str: str) -> Tuple[int, int]:
    """'+z' -> (dir=2, sign=+1); matches WhichDisplaceDir/Sign
    (lib/displace.cpp:152-202)."""
    if (len(disp_str) != 2 or disp_str[0] not in "+-"
            or disp_str[1] not in _DIRS):
        raise ValueError(f"cannot parse displacement string '{disp_str}'")
    return _DIRS[disp_str[1]], (+1 if disp_str[0] == "+" else -1)


def parse_disp_entry(entry: str) -> Tuple[str, int, int]:
    """Parse one displacement entry '+z:1,8' -> ('+z', 1, 8).

    Grammar as in the reference's loop program (tests/loop.cpp:607-631 + the
    start/stop swap sanitisation of loop_mugiq.h:234-239).
    """
    parts = entry.split(":")
    if len(parts) != 2:
        raise ValueError(
            f"displacement entry '{entry}' has the wrong format; "
            "good entries: +z:1,8 , +x:3")
    disp_str = parts[0]
    parse_disp_str(disp_str)
    try:
        lims = [int(s) for s in parts[1].split(",")]
    except ValueError:
        raise ValueError(
            f"displacement entry '{entry}' has non-integer limits; "
            "good entries: +z:1,8 , +x:3") from None
    if len(lims) == 0 or len(lims) > 2:
        raise ValueError(f"wrong limits in displacement entry '{entry}'")
    start = lims[0]
    stop = lims[1] if len(lims) == 2 else lims[0]
    if start > stop:
        start, stop = stop, start
    return disp_str, start, stop
