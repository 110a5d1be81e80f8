"""The traced batch's idle share of the device, in %: 1 minus the union
of every device operation's interval over the batch's host seconds."""


def read(run):
    t = run["traced"]
    if t is None:
        return None
    tr = t["trace"]
    if not tr["events"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
