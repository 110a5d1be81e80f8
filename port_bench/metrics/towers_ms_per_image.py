"""The towers' ms an image sent (a render counts once a question): the
program's ``last_stats["towers_ms"]`` summed over the window's batches,
over the images those batches sent."""


def read(run):
    b = run["batches"]
    sent = sum(x["images_sent"] for x in b)
    if not sent:
        return None
    return sum(x["towers_ms"] for x in b) / sent
