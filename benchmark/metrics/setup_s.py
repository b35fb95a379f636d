"""setup_s: seconds from the process's start to the window's: imports,
parse and sympy, the problem, the kernel libraries (nvcc on a cold
checkout), the start state and the warm episode or call."""


def read(ctx):
    return ctx["setup_s"]
