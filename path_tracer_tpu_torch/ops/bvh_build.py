"""Binned-SAH BVH construction → :class:`FlatBVH`.

Port of ``path_tracer_tpu/ops/bvh_build.py``: the same numpy build (16-bin
SAH sweep, median-split fallback, SAH cluster termination) and the same
BVH-K packing, so both packages produce identical ``nodes``/``prims`` rows.
Host numpy throughout; only the results become torch tensors, placed on the
scene's device.
"""
from __future__ import annotations

import numpy as np

import torch

from .types import (BVH_NONE, PRIM_QUAD, PRIM_ROW, PRIM_SPHERE,
                    PRIM_TRIANGLE, FlatBVH, pad_to)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)

NUM_BINS = 16          # sah_bvh_builder.py:93 bin count
TRAVERSE_COST = 1.0    # sah_bvh_builder.py:99
INTERSECT_COST = 1.5   # sah_bvh_builder.py:100
AABB_PAD = 1e-4        # aabb.py:82 `_pad_to_minimums` delta

# Leaf-termination cost ratio C_traverse / C_intersect for the CLUSTER
# decision (multi-prim leaves).  The reference's 1.0/1.5 ≈ 0.67 models a
# scalar GPU where a node visit and a prim test cost alike; in this
# framework's packed lock-step traversal an embedded prim test rides the
# parent row's step (marginal flops) while descending an interior child
# costs a whole extra step — gather + sort network + stack ops (~18 ns/lane
# vs ~2 ns, docs/PERFORMANCE.md roofline).  A subtree of n ≤ leaf_cap prims
# becomes one K-wide row (a "cluster") when
#   n − (sa_l·n_l + sa_r·n_r)/sa_p  ≤  LEAF_RATIO
# i.e. when the SAH says splitting saves fewer than LEAF_RATIO prim tests
# per ray.  Tuned on-chip (tools/bench_traverse.py sweep).
LEAF_RATIO = 4.0


def primitive_aabbs(scene_np: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Compute (types, indices, bb_min, bb_max) for all *valid* primitives.

    ``scene_np`` holds numpy views of the SceneArrays geometry fields.
    Moving spheres get the union of their t=0 and t=1 boxes (sphere.py:27-31).
    """
    mins, maxs, types, idxs = [], [], [], []

    sv = scene_np["sph_valid"]
    if sv.any():
        c0, c1 = scene_np["sph_c0"][sv], scene_np["sph_c1"][sv]
        r = scene_np["sph_rad"][sv][:, None]
        mins.append(np.minimum(c0 - r, c1 - r))
        maxs.append(np.maximum(c0 + r, c1 + r))
        types.append(np.full(sv.sum(), PRIM_SPHERE, np.int32))
        idxs.append(np.nonzero(sv)[0].astype(np.int32))

    qv = scene_np["qd_valid"]
    if qv.any():
        q = scene_np["qd_q"][qv]
        corners = np.stack(
            [q, q + scene_np["qd_u"][qv], q + scene_np["qd_v"][qv],
             q + scene_np["qd_u"][qv] + scene_np["qd_v"][qv]], axis=1)
        mins.append(corners.min(axis=1))
        maxs.append(corners.max(axis=1))
        types.append(np.full(qv.sum(), PRIM_QUAD, np.int32))
        idxs.append(np.nonzero(qv)[0].astype(np.int32))

    tv = scene_np["tr_valid"]
    if tv.any():
        v0 = scene_np["tr_v0"][tv]
        v1 = v0 + scene_np["tr_e1"][tv]
        v2 = v0 + scene_np["tr_e2"][tv]
        verts = np.stack([v0, v1, v2], axis=1)
        mins.append(verts.min(axis=1))
        maxs.append(verts.max(axis=1))
        types.append(np.full(tv.sum(), PRIM_TRIANGLE, np.int32))
        idxs.append(np.nonzero(tv)[0].astype(np.int32))

    if not mins:
        raise ValueError("empty scene: no valid primitives")

    bb_min = np.concatenate(mins).astype(np.float64)
    bb_max = np.concatenate(maxs).astype(np.float64)
    # Pad degenerate slabs (aabb.py:82-90).
    thin = (bb_max - bb_min) < AABB_PAD
    bb_min = np.where(thin, bb_min - AABB_PAD / 2, bb_min)
    bb_max = np.where(thin, bb_max + AABB_PAD / 2, bb_max)
    return (np.concatenate(types), np.concatenate(idxs), bb_min, bb_max)


def _surface_area(mn: np.ndarray, mx: np.ndarray) -> np.ndarray:
    d = np.maximum(mx - mn, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def presplit_refs(types: np.ndarray, idxs: np.ndarray, bb_min: np.ndarray,
                  bb_max: np.ndarray, budget_frac: float = 0.5):
    """SBVH-style spatial pre-splitting: duplicate oversized primitive
    REFERENCES with their AABBs split at the longest-axis midpoint.

    The union of the two halves equals the original box, so traversal
    correctness is untouched for any primitive type (a prim tested twice
    reports the same closest hit); what changes is tree quality — a
    reference whose box straddles a good split plane no longer forces the
    children to overlap (Stich et al.'s SBVH insight, applied as a cheap
    preprocessing pass instead of in-recursion chopped binning).  The
    split boxes are exact for axis-aligned quads (the flagship's terrain)
    and conservative otherwise.

    Splits go to the references with the largest surface area until the
    reference count grows by ``budget_frac``.
    """
    types = types.copy()
    idxs = idxs.copy()
    bb_min = bb_min.astype(np.float64).copy()
    bb_max = bb_max.astype(np.float64).copy()
    n0 = types.shape[0]
    budget = int(n0 * budget_frac)
    while budget > 0:
        sa = _surface_area(bb_min, bb_max)
        k = min(budget, max(1, len(sa) // 8))
        # Only boxes clearly above the median are worth splitting.
        thresh = 4.0 * np.median(sa)
        cand = np.argsort(sa)[::-1][:k]
        cand = cand[sa[cand] > thresh]
        if cand.size == 0:
            break
        ext = bb_max[cand] - bb_min[cand]
        axis = np.argmax(ext, axis=1)
        rows = np.arange(cand.size)
        mid = 0.5 * (bb_min[cand, axis] + bb_max[cand, axis])
        orig_max = bb_max[cand].copy()
        lo_max = orig_max.copy()
        lo_max[rows, axis] = mid
        hi_min = bb_min[cand].copy()
        hi_min[rows, axis] = mid
        # Left half replaces in place; right half appends.
        bb_max[cand] = lo_max
        types = np.concatenate([types, types[cand]])
        idxs = np.concatenate([idxs, idxs[cand]])
        bb_min = np.concatenate([bb_min, hi_min])
        bb_max = np.concatenate([bb_max, orig_max])
        budget -= cand.size
    return types, idxs, bb_min.astype(np.float32), bb_max.astype(np.float32)


def build_bvh(types: np.ndarray, idxs: np.ndarray, bb_min: np.ndarray,
              bb_max: np.ndarray, use_native: bool = True,
              leaf_cap: int = 1, leaf_ratio: float = LEAF_RATIO) -> FlatBVH:
    """Top-down binned SAH build emitting flat arrays directly.

    FlatBVH leaves always hold exactly one primitive (the node count is
    2n−1 regardless), but with ``leaf_cap > 1`` the build applies SAH
    cost-based *cluster* termination (the multi-prim-leaf analogue of
    sah_bvh_builder.py:206-209's leaf decision): a subtree of ≤ leaf_cap
    prims whose best split saves fewer than ``leaf_ratio`` prim tests per
    ray (see LEAF_RATIO) is emitted as a *balanced* median subtree, which
    ``pack_bvh`` then collapses into exactly one K-wide row with every prim
    payload embedded — one traversal step tests the whole cluster.  When the
    native C++ builder (native/bvh_builder.cpp) is available it does the
    construction; this numpy implementation is the fallback + test oracle.
    """
    if use_native:
        from . import bvh_native
        out = bvh_native.build_bvh_native(
            types, idxs, bb_min.astype(np.float32), bb_max.astype(np.float32),
            leaf_cap=leaf_cap, leaf_ratio=leaf_ratio)
        if out is not None:
            nm, nx, lf, rt, pt_, pi_ = out
            used = nm.shape[0]
            cap2 = pad_to(used)

            def padn(a, fill):
                if cap2 > used:
                    pad_shape = (cap2 - used,) + a.shape[1:]
                    a = np.concatenate([a, np.full(pad_shape, fill, a.dtype)])
                return a

            return FlatBVH(
                bb_min=_t(padn(nm, 0)), bb_max=_t(padn(nx, 0)),
                left=_t(padn(lf, BVH_NONE)),
                right=_t(padn(rt, BVH_NONE)),
                prim_type=_t(padn(pt_, BVH_NONE)),
                prim_idx=_t(padn(pi_, BVH_NONE)))

    n = types.shape[0]
    centroids = 0.5 * (bb_min + bb_max)

    cap = max(2 * n - 1, 1)
    node_min = np.zeros((cap, 3), np.float64)
    node_max = np.zeros((cap, 3), np.float64)
    node_left = np.full(cap, BVH_NONE, np.int32)
    node_right = np.full(cap, BVH_NONE, np.int32)
    node_ptype = np.full(cap, BVH_NONE, np.int32)
    node_pidx = np.full(cap, BVH_NONE, np.int32)
    next_node = [0]

    def alloc() -> int:
        i = next_node[0]
        next_node[0] += 1
        return i

    def _balanced(prim_ids):
        """Median split on the longest centroid axis (cluster emission +
        degenerate fallback, sah_bvh_builder.py:226-231)."""
        cent = centroids[prim_ids]
        ext = cent.max(axis=0) - cent.min(axis=0)
        axis = int(np.argmax(ext)) if ext.max() > 0 else 0
        order = np.argsort(cent[:, axis], kind="stable")
        half = (prim_ids.size + 1) // 2
        return prim_ids[order[:half]], prim_ids[order[half:]]

    def _split(prim_ids, pm, px):
        """Best SAH split → (left_ids, right_ids, saved_tests) where
        ``saved_tests = n − (sa_l·n_l + sa_r·n_r)/sa_p`` is the number of
        prim tests per ray the split saves (−inf when only the degenerate
        median fallback applies: coincident centroids mean no split can
        separate the group, so it always clusters when it fits a row)."""
        cent = centroids[prim_ids]
        cmin, cmax = cent.min(axis=0), cent.max(axis=0)
        ext = cmax - cmin

        best = None  # (cost, axis, bin_split)
        for axis in range(3):
            if ext[axis] < 1e-12:
                continue
            # Bin assignment over the centroid extent (sah_bvh_builder.py:256).
            t = (cent[:, axis] - cmin[axis]) / ext[axis]
            bins = np.minimum((t * NUM_BINS).astype(np.int32), NUM_BINS - 1)
            counts = np.bincount(bins, minlength=NUM_BINS)
            # Per-bin bboxes via reduceat-style masking (vectorised).
            bmin = np.full((NUM_BINS, 3), np.inf)
            bmax = np.full((NUM_BINS, 3), -np.inf)
            np.minimum.at(bmin, bins, pm)
            np.maximum.at(bmax, bins, px)
            # Prefix (left) and suffix (right) scans.
            lmin = np.minimum.accumulate(bmin, axis=0)
            lmax = np.maximum.accumulate(bmax, axis=0)
            rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
            lcount = np.cumsum(counts)
            rcount = counts.sum() - lcount
            # Split after bin k, k in [0, NUM_BINS-2].
            k = np.arange(NUM_BINS - 1)
            valid = (lcount[k] > 0) & (rcount[k] > 0)
            if not valid.any():
                continue
            sa_l = _surface_area(lmin[k], lmax[k])
            sa_r = _surface_area(rmin[k + 1], rmax[k + 1])
            sa_p = max(float(_surface_area(pm.min(axis=0), px.max(axis=0))), 1e-12)
            cost = TRAVERSE_COST + INTERSECT_COST * (
                sa_l * lcount[k] + sa_r * rcount[k]) / sa_p
            cost = np.where(valid, cost, np.inf)
            j = int(np.argmin(cost))
            if best is None or cost[j] < best[0]:
                best = (cost[j], axis, j, bins.copy())

        if best is not None and np.isfinite(best[0]):
            cost, axis, j, bins = best
            mask = bins <= j
            saved = prim_ids.size - (cost - TRAVERSE_COST) / INTERSECT_COST
            return prim_ids[mask], prim_ids[~mask], saved

        lo, hi = _balanced(prim_ids)
        return lo, hi, -np.inf

    # Explicit-stack DFS build (preorder): immune to Python recursion limits
    # on deep trees, and left children land at me+1 (cache-friendly layout).
    # ``forced`` marks cluster interiors: balanced median splits all the way
    # down so pack_bvh's log2(K)-level collapse lands every prim of the
    # cluster in one row.
    work = [(np.arange(n), -1, 0, False)]
    while work:
        prim_ids, parent, side, forced = work.pop()
        me = alloc()
        if parent >= 0:
            if side == 0:
                node_left[parent] = me
            else:
                node_right[parent] = me
        pm, px = bb_min[prim_ids], bb_max[prim_ids]
        node_min[me] = pm.min(axis=0)
        node_max[me] = px.max(axis=0)
        if prim_ids.size == 1:
            node_ptype[me] = types[prim_ids[0]]
            node_pidx[me] = idxs[prim_ids[0]]
            continue
        if forced:
            left_ids, right_ids = _balanced(prim_ids)
        else:
            left_ids, right_ids, saved = _split(prim_ids, pm, px)
            if prim_ids.size <= leaf_cap and saved <= leaf_ratio:
                forced = True
                left_ids, right_ids = _balanced(prim_ids)
        work.append((right_ids, me, 1, forced))
        work.append((left_ids, me, 0, forced))

    used = next_node[0]
    cap2 = pad_to(used)

    def cut(a, fill=None):
        out = a[:used]
        if cap2 > used:
            pad_shape = (cap2 - used,) + out.shape[1:]
            out = np.concatenate([out, np.zeros(pad_shape, out.dtype)
                                  if fill is None else np.full(pad_shape, fill, out.dtype)])
        return out

    return FlatBVH(
        bb_min=_t(cut(node_min).astype(np.float32)),
        bb_max=_t(cut(node_max).astype(np.float32)),
        left=_t(cut(node_left, BVH_NONE)),
        right=_t(cut(node_right, BVH_NONE)),
        prim_type=_t(cut(node_ptype, BVH_NONE)),
        prim_idx=_t(cut(node_pidx, BVH_NONE)),
    )


def build_flat_bvh(scene, leaf_cap: int = 1,
                   leaf_ratio: float = LEAF_RATIO,
                   presplit: float = 0.0, use_native: bool = True) -> FlatBVH:
    """SAH-build the portable flat-node BVH for a compiled scene."""
    scene_np = {
        k: _np(getattr(scene, k))
        for k in ("sph_valid", "sph_c0", "sph_c1", "sph_rad",
                  "qd_valid", "qd_q", "qd_u", "qd_v",
                  "tr_valid", "tr_v0", "tr_e1", "tr_e2")
    }
    refs = primitive_aabbs(scene_np)
    if presplit > 0.0:
        refs = presplit_refs(*refs, budget_frac=presplit)
    return build_bvh(*refs, use_native=use_native, leaf_cap=leaf_cap,
                     leaf_ratio=leaf_ratio)


def pack_bvh(scene, flat: FlatBVH, branching: int = 4):
    """Collapse the binary :class:`FlatBVH` into the ``branching``-wide
    gather-optimised :class:`PackedBVH` traversal layout (see
    types.PackedBVH docstring).  Each row adopts up to K descendant slots,
    chosen greedily by surface area (see ``slots_of`` below).

    Measured on the target TPU: HBM row-gather cost is *flat* in row width
    (~7 ns whether the row is 32 B or 512 B), so the layout packs as much
    per-step work into one row as possible — four children's AABBs,
    pointers, and each leaf child's full prim payload (80 floats).  BVH4
    halves tree depth versus BVH2, halving both gathers and loop overhead
    per ray.

    Child pointer encoding: ``>= 0`` → interior-node row index; ``< 0`` →
    leaf, unified prim id ``-(ptr+1)``; empty slots get never-hit boxes.
    """
    from .types import PackedBVH, bvh_layout

    assert branching in (4, 8)
    ptr_off, payload, node_row = bvh_layout(branching)

    left = _np(flat.left)
    right = _np(flat.right)
    ptype = _np(flat.prim_type)
    pidx = _np(flat.prim_idx)
    bb_min = _np(flat.bb_min)
    bb_max = _np(flat.bb_max)
    leaf = ptype >= 0

    # --- leaf prim rows (16 floats: type, orig_idx, 12 geometry, 2 pad)
    # keyed by binary-node id, numbered in DFS encounter order for locality.
    # Everything the in-flight test can reuse is precomputed here (round-2
    # step-math diet, docs/PERFORMANCE.md): spheres store the motion DELTA
    # and radius² (saves 4 ops/test); quads store the unit plane normal n̂,
    # plane offset d = n̂·Q, and the two planar-coordinate row vectors
    # A = v×w / B = w×u with their offsets A·Q / B·Q, so alpha/beta are
    # affine in t (saves ~30 ops/test vs recomputing the plane from Q/u/v).
    lii = np.nonzero(leaf)[0]
    uid_of = np.full(left.shape[0], -1, np.int64)
    uid_of[lii] = np.arange(lii.shape[0])
    n_leaf = max(int(leaf.sum()), 1)
    prims = np.zeros((n_leaf, PRIM_ROW), np.float32)
    rws = uid_of[lii]
    lt = ptype[lii]
    lp = pidx[lii]
    prims[rws, 0] = lt.astype(np.float32)
    prims[rws, 1] = lp.astype(np.float32)
    sph = lt == 0
    if sph.any():
        r, p = rws[sph], lp[sph]
        c0 = _np(scene.sph_c0)[p]
        prims[r, 2:5] = c0
        prims[r, 5:8] = _np(scene.sph_c1)[p] - c0
        prims[r, 8] = _np(scene.sph_rad)[p] ** 2
    qd = lt == 1
    if qd.any():
        r, p = rws[qd], lp[qd]
        q = _np(scene.qd_q)[p].astype(np.float64)
        u = _np(scene.qd_u)[p].astype(np.float64)
        v = _np(scene.qd_v)[p].astype(np.float64)
        n_raw = np.cross(u, v)
        nn2 = np.maximum((n_raw * n_raw).sum(-1, keepdims=True), 1e-30)
        n_hat = n_raw / np.sqrt(nn2)
        w = n_raw / nn2
        A = np.cross(v, w)   # alpha = w·((p−Q)×v) = A·(p−Q)
        B = np.cross(w, u)   # beta  = w·(u×(p−Q)) = B·(p−Q)
        prims[r, 2:5] = n_hat
        prims[r, 5:8] = A
        prims[r, 8:11] = B
        prims[r, 11] = (n_hat * q).sum(-1)
        prims[r, 12] = (A * q).sum(-1)
        prims[r, 13] = (B * q).sum(-1)
    tr = lt == 2
    if tr.any():
        r, p = rws[tr], lp[tr]
        prims[r, 2:5] = _np(scene.tr_v0)[p]
        prims[r, 5:8] = _np(scene.tr_e1)[p]
        prims[r, 8:11] = _np(scene.tr_e2)[p]

    if leaf[0]:
        # Single-prim scene: root is a leaf; no interior rows needed.
        nodes = np.zeros((1, node_row), np.float32)
        root_ptr = -(uid_of[0] + 1)
        max_stack = 1
    else:
        # --- BVH2 → BVH-K collapse: each kept interior node adopts up to K
        # descendant slots, chosen GREEDILY by surface area (VERDICT r4 #1):
        # start from the node's two children and repeatedly expand the
        # interior slot with the largest box until K slots are used.  A hot
        # (large-SA) subtree gets the full fanout where the fixed
        # ``levels``-generation collapse wasted slots on leaves met early —
        # expansion saves one whole traversal step (gather + sort network +
        # stack ops) every time a ray would have descended that slot.
        sa_node = _surface_area(bb_min, bb_max)

        def slots_of(x):
            out = [left[x], right[x]]
            while len(out) < branching:
                cand = [(sa_node[s], i) for i, s in enumerate(out)
                        if not leaf[s]]
                if not cand:
                    break
                _, i = max(cand)
                s = out.pop(i)
                out[i:i] = [left[s], right[s]]
            return out  # 2..K binary-node ids

        new_index = {0: 0}
        order_nodes = [0]
        qi = 0
        slot_lists = {}
        while qi < len(order_nodes):
            x = order_nodes[qi]
            qi += 1
            sl = slots_of(x)
            slot_lists[x] = sl
            for s in sl:
                if not leaf[s] and s not in new_index:
                    new_index[s] = len(order_nodes)
                    order_nodes.append(s)

        nodes = np.zeros((len(order_nodes), node_row), np.float32)
        # Empty slots: sentinel pointer (an inverted-box trick would NOT
        # work — for a ray with all-negative direction the slab min/max
        # swaps neutralise the inversion and the box "hits").
        from .types import BVH_EMPTY_SLOT
        for i in range(branching):
            nodes[:, ptr_off + i] = float(BVH_EMPTY_SLOT)
        for x in order_nodes:
            row = new_index[x]
            for i, s in enumerate(slot_lists[x]):
                nodes[row, 6 * i:6 * i + 3] = bb_min[s]
                nodes[row, 6 * i + 3:6 * i + 6] = bb_max[s]
                if leaf[s]:
                    nodes[row, ptr_off + i] = float(-(uid_of[s] + 1))
                    nodes[row, payload + PRIM_ROW * i:
                          payload + PRIM_ROW * (i + 1)] = prims[uid_of[s]]
                else:
                    nodes[row, ptr_off + i] = float(new_index[s])
        root_ptr = 0

        # Exact worst-case traversal stack need (static, per-tree).  The
        # step descends the nearest interior child and pushes the other
        # interior children, so while any node is being processed the stack
        # holds at most (k−1) of each ancestor's k interior children:
        #   need(n) = max(0, k−1) + max over interior children of need(c).
        # order_nodes is BFS order (children index > parent), so a reverse
        # sweep is a valid postorder.  Sized stacks cut the one-hot
        # push/pop select work per step ~2-3× vs the fixed 48 default.
        need = np.zeros(len(order_nodes), np.int64)
        for x in reversed(order_nodes):
            ints = [s for s in slot_lists[x] if not leaf[s]]
            child_need = max((need[new_index[s]] for s in ints), default=0)
            need[new_index[x]] = max(0, len(ints) - 1) + child_need
        max_stack = max(int(need[0]), 1) + 1  # +1 safety slot

    def padrows(a):
        n = pad_to(a.shape[0], 1)
        if n > a.shape[0]:
            a = np.concatenate([a, np.zeros((n - a.shape[0], a.shape[1]),
                                            a.dtype)])
        return a

    return PackedBVH(
        nodes=_t(padrows(nodes), scene.sph_c0.device),
        prims=_t(padrows(prims), scene.sph_c0.device),
        root=torch.tensor(int(root_ptr), dtype=torch.int32,
                          device=scene.sph_c0.device),
        prim_mask=(bool((lt == 0).any()), bool((lt == 1).any()),
                   bool((lt == 2).any())),
        max_stack=int(max_stack),
        branching=branching,
    )


def build_from_scene(scene, branching: int = 4,
                     leaf_ratio: float = LEAF_RATIO,
                     presplit: float = 0.0, use_native: bool = True):
    """SAH build + traversal packing: the one-call acceleration-structure
    entry point (returns :class:`PackedBVH`, what the engines consume).

    ``leaf_cap`` is tied to ``branching``: a cluster of ≤ K prims collapses
    into exactly one K-wide row with all payloads embedded.  ``presplit``
    > 0 runs the SBVH-style reference pre-splitting pass first (see
    :func:`presplit_refs`)."""
    return pack_bvh(scene,
                    build_flat_bvh(scene, leaf_cap=branching,
                                   leaf_ratio=leaf_ratio,
                                   presplit=presplit,
                                   use_native=use_native),
                    branching=branching)
