"""Waves the wavefront's device loop ran (``RenderStats.waves``) per
sample of the frame, over the window; nothing where no wave ran."""


def read(ctx):
    c = ctx["record"].counters
    if not c.get("waves") or not c.get("samples"):
        return None
    return c["waves"] / c["samples"]
