"""The peak device memory allocated during the window, above what was
allocated when the window began (the input pool and the tables), in
GiB."""


def read(run):
    return run.step_peak_bytes / 2**30
