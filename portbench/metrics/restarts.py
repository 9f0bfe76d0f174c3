"""restarts: the eigensolver's restarts (ProductionResult.n_restarts), mean
per configuration."""


def read(run):
    return sum(c.n_restarts for c in run.calls) / len(run.calls)
