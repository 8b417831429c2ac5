"""Share of the traced slice in which no operation ran on the device:
1 - (union of device intervals) / (host seconds of the slice), in %."""


def read(ctx):
    tr = ctx["record"].trace
    if not tr or not tr["consistent"] or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
