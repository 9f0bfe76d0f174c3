"""measure_s: the program's PROFILE phases "loop-contraction" (K2, K3) and
"momentum-projection" (g5 map, momentum GEMM) per configuration."""


def read(run):
    return run.phase_mean("loop-contraction", "momentum-projection")
