"""``torch.cuda.max_memory_allocated`` over set-up and the window, GiB."""


def read(run):
    return run.memory_peak_bytes / 2 ** 30 if run.memory_peak_bytes else None
