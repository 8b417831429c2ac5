"""The walks' 16-byte traversal step against the 4-byte one, step by step.

``csrc/traverse.cuh`` holds two steps of the closest-hit walk: ``trav_step``
(4-byte loads of the node row, the child loop unrolled; the reference
here) and ``trav_step16`` (16-byte loads, the children tested in pairs;
K5 and K6 walk it with the pair loop rolled, K7 and K9 unrolled, and both
are checked).  Built by g++ (``csrc/host_emulation.cpp``), each runs one step of
every walking slot of the same mid-flight wave state, and the states after
the step must be equal exactly: node, stack, ``sp``, ``best_t``, the best
primitive and the counters (steps, dropped pushes).  On vol2_final pools at
K = 4 and K = 8 where a leaf child's hit clips a later child's box within
a step (``_clip_events``, the order of the leaf and box tests must be the
child order), with the pool's stack and with a 2-entry stack, where pushes
are dropped at a full stack and counted.
"""
import dataclasses
import shutil

import pytest
import torch

from path_tracer_tpu_torch.ops import kernels
from path_tracer_tpu_torch.ops import traverse as ttr
from path_tracer_tpu_torch.ops import wavefront as twf
from path_tracer_tpu_torch.ops.types import C_STACK_OVF

from test_torch_wave_exit import _clip_events, _engine, _setup

FIELDS = ("cur", "stack", "sp", "best_t", "best_pt", "best_pi", "ctr")
STEPS = 12            # steps compared from each pool
POOLS = (2, 5)        # pools taken after these waves


@pytest.fixture(scope="module")
def walk_step():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    return kernels.host_emulation_walk_step()


@pytest.mark.parametrize("sd", [None, 2], ids=["pool_stack", "full_stack"])
@pytest.mark.parametrize("branching", [4, 8])
def test_step16_equals_step_exactly(walk_step, branching, sd):
    setup = _setup("vol2_final_scene", 32, branching)
    if sd is not None:
        setup = (*setup[:4], dataclasses.replace(setup[4], stack_depth=sd))
    eng, ws = _engine(setup, chunk=4)
    assert eng.bvh.branching == branching
    assert sd is None or eng.sd == sd
    events = walked = 0
    for wave in range(max(POOLS) + 1):
        for op in twf.PLAIN:
            op(eng, ws)
        if wave not in POOLS:
            continue
        s = ws.clone()
        if sd is None:
            events += _clip_events(eng, s.clone(), STEPS)
        for _ in range(STEPS):
            walked += int((s.cur != ttr._DONE).sum())
            old = s.clone()
            walk_step(eng, old, 0)
            for step in (1, 2):
                new = s.clone()
                walk_step(eng, new, step)
                for f in FIELDS:
                    assert torch.equal(getattr(new, f), getattr(old, f)), \
                        (f, step)
            s = old
    assert walked > 0
    if sd is None:
        assert events > 0            # leaf hits clipped later boxes
        assert int(ws.ctr[C_STACK_OVF]) == 0
    else:
        assert int(s.ctr[C_STACK_OVF]) > int(ws.ctr[C_STACK_OVF])
