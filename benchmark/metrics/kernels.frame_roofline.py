"""The least time the traced slice's work needs at the H100's peaks
(``roofline.bound_s``: the sample set's operations, the scene read once and
each frame written once; traversal not counted) as a percentage of the
device time of the port's kernels; nothing where that time was not
measured consistently."""
import roofline
from reference import scene as rscene


def read(ctx):
    rec = ctx["record"]
    tr, sl = rec.trace, rec.slice_counters
    if not tr or not tr["consistent"] or not tr["kernel_s"] or not sl:
        return None
    scene_bytes = roofline.tensor_bytes(rscene.compile_desc(rec.output["desc"]))
    return roofline.share_pct(sl["pixel_samples"], sl["rays"],
                              sl["walk_steps"], device_s=tr["kernel_s"],
                              read_bytes=scene_bytes,
                              frame_pixels=sl["frames"] * sl["pixels"])
