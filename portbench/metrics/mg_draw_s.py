"""mg_draw_s: the program's PROFILE phase "mg-null-vector-draw-l0" (the host
draw of the level-0 null vectors) per configuration."""


def read(run):
    return run.phase_mean("mg-null-vector-draw-l0")
