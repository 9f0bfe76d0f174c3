"""operator_setup_s: the program's PROFILE phase "operator-setup" (host prep
and operator build) per configuration."""


def read(run):
    return run.phase_mean("operator-setup")
