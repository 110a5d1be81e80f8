"""Milliseconds a decode step the host spends issuing it: the program's
``decode_issue_ms`` (the ``decode.issue`` spans: the step's launch, the
next id's choice and its bookkeeping) summed over the window's batches,
over their ``decode_steps``."""


def read(run):
    b = run["batches"]
    steps = sum(x["decode_steps"] for x in b)
    if not steps or any("decode_issue_ms" not in x for x in b):
        return None
    return sum(x["decode_issue_ms"] for x in b) / steps
