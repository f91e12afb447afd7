"""Peak device memory allocated over the traced window (GiB), by
``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``
at the window's start."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30
