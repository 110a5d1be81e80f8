"""The card's peak allocated memory over set-up, window and trace, GiB
(``torch.cuda.max_memory_allocated``)."""


def read(run):
    return run["peak_bytes"] / 2 ** 30 if run["peak_bytes"] else None
