"""peak_mem_GB: torch.cuda.max_memory_allocated() over the timed calls, the
largest of the calls' peaks (reset before each), in 1e9 bytes."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
