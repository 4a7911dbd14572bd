"""Seconds from the process's start to the window's: the interpreter, CUDA
initialisation, the kernel library's build or load, the scene's build and
replication, the start check and the warm-up steps."""


def read(run):
    return run["setup_s"]
