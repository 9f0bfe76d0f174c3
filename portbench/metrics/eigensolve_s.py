"""eigensolve_s: the program's PROFILE phases "eigensolve" and
"rayleigh-ritz-refine" per configuration."""


def read(run):
    return run.phase_mean("eigensolve", "rayleigh-ritz-refine")
