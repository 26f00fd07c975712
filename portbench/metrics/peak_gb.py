"""``peak_gb``: the most device memory the run's allocator held, set-up
and window included, before the reference ran, in GB (1e9 bytes)."""


def read(r):
    return r.memory_peak_bytes / 1e9 if r.memory_peak_bytes else None
