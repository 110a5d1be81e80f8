"""Milliseconds a decode step: the program's ``decode_ms`` summed over the
window's batches, over their ``decode_steps`` (steps that feed a prompt
id past the prefill bucket count as steps)."""


def read(run):
    b = run["batches"]
    steps = sum(x["decode_steps"] for x in b)
    if not steps:
        return None
    return sum(x["decode_ms"] for x in b) / steps
