"""Seconds from the process's start to the window's opening: imports,
the kernels' build where it is stale, the weights drawn, the engine and
every graph of the cell's shapes captured.  Host clock."""


def read(run):
    return run.setup_s
