"""Traced segments (``RenderStats.rays``, counted on the device and read
back once a batch) per second of the window, in millions."""


def read(ctx):
    rec = ctx["record"]
    rays = rec.counters.get("rays")
    if not rays:
        return None
    return rays / rec.window_s / 1e6
