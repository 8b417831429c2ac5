"""Faults planted under the timed path: each wraps the Renderer's batch
call ``_render_batch(..., accum, start_sample, n_samples, key, engine,
tuned)`` → ``(accum, stats)``."""


def state_unchanged(orig):
    """The batch runs but hands back its input frame."""
    def call(scene, flags, bvh, cam, cfg, accum, start, n, key, engine,
             tuned=None):
        _, stats = orig(scene, flags, bvh, cam, cfg, accum, start, n, key,
                        engine, tuned=tuned)
        return accum, stats
    return call


def half_batch(orig):
    """Half of the batch's samples left out, the rest counted double."""
    def call(scene, flags, bvh, cam, cfg, accum, start, n, key, engine,
             tuned=None):
        out, stats = orig(scene, flags, bvh, cam, cfg, accum, start,
                          max(1, n // 2), key, engine, tuned=tuned)
        return accum + (out - accum) * (n / max(1, n // 2)), stats
    return call


def altered(orig):
    """Each sample's colour altered where it is made: its red and blue
    swapped."""
    def call(scene, flags, bvh, cam, cfg, accum, start, n, key, engine,
             tuned=None):
        out, stats = orig(scene, flags, bvh, cam, cfg, accum, start, n, key,
                          engine, tuned=tuned)
        return accum + (out - accum)[..., [2, 1, 0]], stats
    return call


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "altered": altered}
