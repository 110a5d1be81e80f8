"""Answers a second: every request of the window's completed batches
(one answer each), over those batches' host seconds."""


def read(run):
    b = run["batches"]
    return sum(x["rows"] for x in b) / sum(x["seconds"] for x in b)
