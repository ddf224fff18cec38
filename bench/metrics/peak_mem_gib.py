"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over set-up, the
window and any traced rounds, read before the reference runs."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
