"""Milliseconds a batch that the host spends building the wavefront's loop
graph (``wavefront.graph_build``: arguments, capture, instantiation) and
freeing it (``wavefront.graph_free``); None where no graph was built (the
megakernel, the CPU) or without spans."""
from harness import spans


def read(ctx):
    return spans.ms_per_batch(
        "wavefront.graph_build",
        plus=("wavefront.graph_build", "wavefront.graph_free"))
