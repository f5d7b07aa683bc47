"""Seconds from the process's start to the window's: imports, the build of
the program and its kernels, the weights, the warm-up wave; host clock."""


def read(rec):
    return rec["setup_s"]
