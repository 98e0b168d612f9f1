"""Peak device memory allocated in the window (the allocator's peak, reset
at the window's start), in GiB."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30 if rec["peak_bytes"] else None
