"""Wall clock from the start of the process to the start of the window:
imports, the kernels' load (and build, in a checkout's first run), the
entry's tables, the ring, the warm-up."""


def value(w) -> float:
    return w.setup_s
