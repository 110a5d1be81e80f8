"""The share of the decode loop's row-steps that feed an id the caller
asked for, in %: the program's ``row_steps_asked`` (a generated id of
index below ``max_gen_len``, before the row's stop) summed over the
window's batches, over their rows x ``decode_steps``."""


def read(run):
    b = run["batches"]
    row_steps = sum(x["rows"] * x["decode_steps"] for x in b)
    if not row_steps or any("row_steps_asked" not in x for x in b):
        return None
    return 100.0 * sum(x["row_steps_asked"] for x in b) / row_steps
