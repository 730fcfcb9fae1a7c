"""The card's peak allocated memory over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), the
largest over the ranks, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
