"""Prefill microseconds a token: the program's ``last_stats["prefill_ms"]``
summed over the window's batches, over the tokens those prefills took:
rows x (the prefill bucket + the image words)."""


def read(run):
    b = run["batches"]
    tokens = sum(x["rows"] * (x["bucket"] + x["image_words"]) for x in b)
    return 1e3 * sum(x["prefill_ms"] for x in b) / tokens
