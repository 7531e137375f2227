"""setup_s (s): from the process's start to the window's first tick:
imports, rendering the replay, building the engine (and the kernels, in the
first run of a checkout), warm-up."""


def read(run):
    return run.setup_s
