"""mg_setup_s: the program's PROFILE phase "mg-setup" (null vectors,
transfer, Galerkin) per configuration; nothing where no MG set-up ran."""


def read(run):
    return run.phase_mean("mg-setup")
