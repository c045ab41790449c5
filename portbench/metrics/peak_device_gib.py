"""``torch.cuda.max_memory_allocated()`` over the window (the peak is
reset when set-up ends), in GiB; None off a CUDA device."""


def read(run):
    return run.peak_window_bytes / 2 ** 30 if run.peak_window_bytes else None
