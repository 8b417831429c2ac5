"""The benchmark's plain reference renderer: plain PyTorch, independent of
the program under test.

It compiles the scene description itself (:mod:`.scene`), finds each
closest hit by testing every primitive (no acceleration structure), and
shades with the published integrator's rules and random-number chain
(:mod:`.tracer`: threefry2x32 ``fold_in`` keys base -> sample -> pixel ->
bounce, :mod:`.rng`), so for a given key it integrates the same
(sample, pixel, bounce) set as any correct implementation.  It imports
nothing of the program and reads none of its state.
"""
