"""Milliseconds a decode step the host waits for the card: the program's
``decode_wait_ms`` (the ``decode.wait`` spans around the loop's read of
the stop flags) summed over the window's batches, over their
``decode_steps``."""


def read(run):
    b = run["batches"]
    steps = sum(x["decode_steps"] for x in b)
    if not steps or any("decode_wait_ms" not in x for x in b):
        return None
    return sum(x["decode_wait_ms"] for x in b) / steps
