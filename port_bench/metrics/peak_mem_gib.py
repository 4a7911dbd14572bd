"""torch.cuda.max_memory_allocated() over the window (after
reset_peak_memory_stats() at its start), in GiB; nothing off the card."""


def read(run):
    return run["window_peak_bytes"] / 2**30 if run["window_peak_bytes"] else None
