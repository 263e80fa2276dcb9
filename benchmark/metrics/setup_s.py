"""Set-up: from the process's start to the first timed call (imports,
the kernel library's build or load, the tables, the input pool and the
warm-up call)."""


def read(run):
    return run.setup_s
