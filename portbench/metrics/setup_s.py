"""Process start to the first timed call, in s: imports, the program's
set-up (cosmology tables, kernel build or load, plans), the cell's
warm-up calls."""


def read(run):
    return run.setup_s
