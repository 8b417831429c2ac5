"""Device milliseconds of the port's own kernels (torch.profiler, the
traced slice) per sample of the frame; nothing where the profiler's runs
disagree with the program's launch counts."""


def read(ctx):
    rec = ctx["record"]
    tr, sl = rec.trace, rec.slice_counters
    if not tr or not tr["consistent"] or not tr["kernel_s"] or not sl:
        return None
    return 1e3 * tr["kernel_s"] / sl["samples"]
