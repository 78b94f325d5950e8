"""Full SLAM pipeline: grid tracking + keyframe pose graph + loop closure.

This is BASELINE config[3] ("full pipeline with pose-graph loop closure"):
the single-hypothesis tracker (tiny/viny style) runs per scan; keyframes are
gated by travel distance; each new keyframe is matched against old nearby
keyframes for loop closures; when a loop closes, the SE(2) Gauss-Newton
solver re-optimizes the keyframe graph, the tracker pose is re-anchored, and
the map is regenerated from optimized keyframes.

Host/device split (the PP axis of SURVEY.md §2.9): per-scan tracking is one
jitted step; keyframe/loop/optimize work runs at keyframe rate in separate
jitted functions — the low-rate "bundle-adjustment stage" overlapping the
high-rate tracking stage.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..ops import grid as gridlib
from ..ops.geometry import between, compose, pose_distance
from ..ops.scan import LaserScan
from . import posegraph as pg
from .engine import EngineConfig, SlamState, init_state, slam_step
from .tiny import tiny_config

#: device-side "no keyframe yet" sentinel: far enough that the first scan
#: always trips the keyframe gate, small enough that f32 distance math is
#: exact (1e6 << f32 range)
_NO_KF = (1.0e6, 1.0e6, 0.0)


@partial(jax.jit, static_argnums=(0, 1, 2))
def track_segment(
    cfg: EngineConfig,
    kf_distance: float,
    kf_angle_weight: float,
    state: SlamState,
    last_kf_pose: jax.Array,
    scans: LaserScan,
    odom: jax.Array,
):
    """Device-resident tracking over a scan segment with an on-device
    keyframe gate.

    A host-side gate would force one device->host fetch per scan, capping
    the full pipeline at the fetch rate regardless of kernel speed. Here
    the gate (the reference's
    keyframe-distance test) runs inside ``lax.scan``; the host fetches the
    per-scan poses and keyframe flags ONCE per segment and does graph work
    (add/detect/optimize) at keyframe rate. Loop closures therefore land
    with up to one segment of latency — the PP tradeoff of SURVEY.md §2.9
    (the BA stage runs at lower rate, overlapped with tracking).

    Returns ``(state, last_kf_pose, poses f32[S,3], kf_flags bool[S])``.
    """

    def body(carry, inp):
        st, last_kf = carry
        scan, od = inp
        st = slam_step(cfg, st, scan, od)
        is_kf = (
            pose_distance(last_kf, st.pose, kf_angle_weight) > kf_distance
        )
        last_kf = jnp.where(is_kf, st.pose, last_kf)
        return (st, last_kf), (st.pose, is_kf)

    (state, last_kf_pose), (poses, flags) = jax.lax.scan(
        body, (state, last_kf_pose), (scans, odom)
    )
    return state, last_kf_pose, poses, flags


def _between_np(a, b):
    """Numpy twin of geometry.between for host-side anchor bookkeeping
    (keeps per-segment anchor math off the device entirely)."""
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    x = c * dx + s * dy
    y = -s * dx + c * dy
    th = (b[..., 2] - a[..., 2] + np.pi) % (2 * np.pi) - np.pi
    return np.stack([x, y, th], axis=-1).astype(np.float32)


@partial(
    jax.jit, static_argnums=(0, 1, 2, 3, 4, 5, 6),
    donate_argnums=(7, 8, 9, 10, 11),
)
def _segment_fused_fn(
    tcfg: EngineConfig,
    gcfg: pg.PoseGraphConfig,
    densify_rounds: int,
    opt_every: int,
    max_kf: int,
    kb: int,
    reexpress: bool,
    state: SlamState,
    last_kf_pose: jax.Array,
    anchor_pose: jax.Array,  # f32[3] trajectory-anchor keyframe pose
    graph: pg.PoseGraphState,
    pending: jax.Array,  # i32[] loop constraints since last optimize
    all_scans: LaserScan,
    all_odom: jax.Array,
    s0: jax.Array,  # i32[] segment start offset into all_scans/all_odom
):
    """ONE dispatch per segment: tracking + batched keyframe add/detect +
    (conditional) closure burst, all device-resident.

    Per segment the unfused driver dispatches track + ~3 kf_batch + a
    loop-count fetch + a closure burst. This fuses the whole segment into
    one program; the host fetches one results tuple per segment (poses for
    trajectory anchors + counters) and only does capacity bookkeeping.

    The segment takes the FULL sequence + a traced offset ``s0`` and
    slices ``max_kf`` scans inside the jit: a host-side per-segment
    ``tree.map(lambda a: a[s0:s1], scans)`` would dispatch one device
    slice per pytree leaf.

    Keyframe selection: ``max_kf`` = the segment length, so EVERY flagged
    scan is processed on-device, in ``kb``-wide batches (each exact per
    process_keyframes' batched path when kb <= min_index_gap) under a
    ``fori_loop`` whose empty batches cond-skip — one compiled batch
    program regardless of how many keyframes a segment produces. (An
    earlier draft capped max_kf below the segment length and let the host
    add the overflow remainder AFTER the in-dispatch closure burst; those
    keyframes' tracked poses were in the PRE-optimize frame while the
    graph had moved — corrupted chain edges, lost loops, ATE 0.24 vs
    0.07 on the quality bench. Keyframe work must complete before the
    burst.)

    The closure burst (densify + GN optimize + tracker re-anchor + map
    regeneration) fires at KEYFRAME-BATCH cadence — after any kb-keyframe
    batch whose detections push ``pending`` past ``opt_every``. That is
    closer to the reference's per-keyframe optimize cadence than the host
    loop's once-per-segment gate, and it decouples correction latency
    from the segment length — segments can grow to the whole sequence
    (one dispatch, monolithic-scan dispatch cost) without deferring
    closures to the end.

    Trajectory anchors (which keyframe each scan hangs off, and the
    body-frame delta) are computed ON DEVICE in the tracking scan — the
    host no longer needs the per-segment poses at all, so the results
    fetch can be deferred across ``sync_every`` segments and the segment
    dispatches pipeline through JAX's async queue (round-4: after fusing
    to one dispatch/segment, the per-segment fetch was the remaining
    serialization).

    Returns ``(state, last_kf_pose, anchor_pose, graph, pending, packed)``
    — ``last_kf_pose`` is the (possibly optimize-corrected) keyframe-gate
    anchor; ``packed f32[S+2, 8]`` rows are per-scan
    ``[pose(3), flag, anchor_idx, delta(3)]``, then a counter row
    ``[new_loops, overflow, closed, n_kf, n_edges, 0, 0, 0]``, then a
    tail row ``[anchor_pose(3), last_kf_pose(3), pending, 0]`` — the tail
    row exists so the HOST never reads ``pending``/``anchor_pose``/
    ``last_kf_pose`` as separate device fetches (every np.asarray is its
    own device->host round trip).
    """
    model = tcfg.cell_model
    s_len = max_kf
    scans = jax.tree.map(
        lambda a: jax.lax.dynamic_slice_in_dim(a, s0, s_len, 0), all_scans
    )
    odom = jax.lax.dynamic_slice_in_dim(all_odom, s0, s_len, 0)
    base = graph.n_kf  # keyframe count BEFORE this segment's adds

    def body(carry, inp):
        st, last_kf, anch, kf_cnt = carry
        scan, od = inp
        st = slam_step(tcfg, st, scan, od)
        is_kf = (
            pose_distance(last_kf, st.pose, gcfg.keyframe_angle_weight)
            > gcfg.keyframe_distance
        )
        last_kf = jnp.where(is_kf, st.pose, last_kf)
        kf_cnt = kf_cnt + is_kf.astype(jnp.int32)
        anch = jnp.where(is_kf, st.pose, anch)
        # trajectory anchor: the latest keyframe at record time (mirrors
        # the host bookkeeping run_segments does from fetched flags)
        a_idx = jnp.maximum(base + kf_cnt - 1, 0)
        delta = between(anch, st.pose)
        return (st, last_kf, anch, kf_cnt), (
            st.pose, is_kf, a_idx.astype(jnp.float32), delta
        )

    (state, last_kf_pose, anchor_pose, _), (poses, flags, a_idx, deltas) = (
        jax.lax.scan(
            body, (state, last_kf_pose, anchor_pose, jnp.int32(0)),
            (scans, odom),
        )
    )

    n_batches = -(-max_kf // kb)
    kf_idx = jnp.nonzero(flags, size=n_batches * kb, fill_value=s_len)[0]

    # closure burst: densify + GN optimize + tracker/gate/anchor re-anchor
    # + map regeneration. Fires at BATCH cadence (after any kb-keyframe
    # batch whose detections push ``pending`` past ``opt_every``) — closer
    # to the reference's per-keyframe optimize cadence than the earlier
    # per-segment gate, and what lets a SEGMENT grow to the whole sequence
    # (one dispatch, monolithic-scan speed) without deferring every
    # correction to the end.
    def burst(args):
        g, st, pend, lkf, anch, ps = args
        last = g.last_kf
        before = g.kf_poses[last]
        before_all = g.kf_poses
        extra = jnp.int32(0)
        for _ in range(densify_rounds):
            g, n_new = pg.densify_loops(gcfg, model, g)
            extra = extra + n_new
        g = pg.optimize(gcfg, g)
        after = g.kf_poses[last]
        new_pose = compose(after, between(before, st.pose))

        # regenerate the map only when the optimization actually MOVED a
        # keyframe (> ~half a cell): once the graph has converged, most
        # bursts produce sub-cell corrections and the K-keyframe
        # re-rasterization — the burst's dominant cost — buys nothing
        # (round-3 verdict lever (b), incremental regeneration)
        kf_used = jnp.arange(gcfg.max_keyframes) < g.n_kf
        moved = jnp.where(
            kf_used[:, None], jnp.abs(g.kf_poses - before_all), 0.0
        ).max()
        def do_regen(st_gm):
            fresh = gridlib.make_grid_map(
                model, tcfg.map_height, tcfg.map_width, tcfg.map_scale
            )
            return pg.regenerate_map(gcfg, model, g, fresh, beam=tcfg.beam)
        gm = jax.lax.cond(
            moved > 0.5 * tcfg.map_scale, do_regen, lambda st_gm: st_gm, st.gm
        )
        # re-express the not-yet-processed tracked poses in the corrected
        # frame (pose' = after ∘ before⁻¹ ∘ pose): keyframes added in
        # batches AFTER this burst must carry post-optimize poses, else
        # the chain edge bridging the burst mixes frames and loop
        # detection centers its window on a stale pose (r4 advisor
        # finding; the same frame-mixing hazard as the max_kf-cap draft)
        if reexpress:
            ps = compose(after, between(before, ps))
        # the gate AND the trajectory anchor both move to the optimized
        # keyframe pose (post-burst scans must anchor their deltas off the
        # corrected keyframe — the host bookkeeping did exactly this)
        return (
            g, st.replace(gm=gm, pose=new_pose), jnp.int32(0), extra,
            after, after, ps,
        )

    def no_burst(args):
        g, st, pend, lkf, anch, ps = args
        return g, st, pend, jnp.int32(0), lkf, anch, ps

    def batch_body(bi, carry):
        g, nl, pend, st, lkf, anch, ps = carry
        idx_b = jax.lax.dynamic_slice(kf_idx, (bi * kb,), (kb,))
        valid_b = idx_b < s_len
        idx_c = jnp.clip(idx_b, 0, s_len - 1)

        def do_batch(g):
            scans_k = jax.tree.map(lambda a: a[idx_c], scans)
            return pg.process_keyframes(
                gcfg, model, g, scans_k, ps[idx_c], valid_b
            )

        g, nl_b = jax.lax.cond(
            valid_b.any(), do_batch, lambda g: (g, jnp.int32(0)), g
        )
        pend = pend + nl_b
        g, st, pend, extra, lkf, anch, ps = jax.lax.cond(
            pend >= opt_every, burst, no_burst, (g, st, pend, lkf, anch, ps)
        )
        return g, nl + nl_b + extra, pend, st, lkf, anch, ps

    (graph, new_loops, pending, state, last_kf_pose, anchor_pose, _) = (
        jax.lax.fori_loop(
            0, n_batches, batch_body,
            (graph, jnp.int32(0), pending, state, last_kf_pose, anchor_pose,
             poses),
        )
    )
    extra_loops = jnp.int32(0)
    closed = pending < opt_every  # diagnostics only (bursts are per batch)
    overflow = graph.kf_overflow | graph.edge_overflow
    # ONE host-visible array per segment: rows 0..S-1 =
    # [pose(3), flag, anchor_idx, delta(3)]; last row = counters. Every
    # np.asarray is a device->host round trip, so the host must not fetch
    # poses, flags, anchors, and counters
    # separately — and with anchors on device it need not fetch per
    # segment at all (the driver concatenates several segments' packed
    # arrays on device and fetches once per sync_every).
    counters = (
        jnp.zeros((1, 8), jnp.float32)
        .at[0, 0].set((new_loops + extra_loops).astype(jnp.float32))
        .at[0, 1].set(overflow.astype(jnp.float32))
        .at[0, 2].set(closed.astype(jnp.float32))
        .at[0, 3].set(graph.n_kf.astype(jnp.float32))
        .at[0, 4].set(graph.n_edges.astype(jnp.float32))
    )
    tail = (
        jnp.zeros((1, 8), jnp.float32)
        .at[0, 0:3].set(anchor_pose)
        .at[0, 3:6].set(last_kf_pose)
        .at[0, 6].set(pending.astype(jnp.float32))
    )
    packed = jnp.concatenate(
        [
            jnp.concatenate(
                [poses, flags[:, None].astype(jnp.float32),
                 a_idx[:, None], deltas], 1,
            ),
            counters,
            tail,
        ],
        axis=0,
    )
    return state, last_kf_pose, anchor_pose, graph, pending, packed


@partial(jax.jit, static_argnums=(0, 1))
def _kf_batch_fn(gcfg, model, graph, loops_acc, seg_scans, seg_poses, idx, valid):
    """Gather + add + detect + loop-count accumulate in ONE dispatch.

    Module-level (static config args) so the jit cache is shared across
    FullSlamEngine instances: per-instance closures recompiled inside
    benchmark timed regions (round-3 ADVICE finding) — XLA compile time of
    the graph-work programs was billed to the full pipeline's throughput."""
    scans_k = jax.tree.map(lambda a: a[idx], seg_scans)
    poses_k = seg_poses[idx]
    graph, nl = pg.process_keyframes(gcfg, model, graph, scans_k, poses_k, valid)
    return graph, loops_acc + nl


@partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _close_burst_fn(gcfg, model, beam, densify_rounds, graph, state, fresh_gm):
    """One dispatch per closure burst: densify rounds (fixed count,
    no-candidates rounds are no-ops) + GN optimize + tracker re-anchor +
    map regeneration (the unfused version cost ~4-5 host round trips per
    burst). Module-level for cache sharing."""
    last = graph.last_kf
    before = graph.kf_poses[last]
    total_new = jnp.int32(0)
    for _ in range(densify_rounds):
        graph, n_new = pg.densify_loops(gcfg, model, graph)
        total_new = total_new + n_new
    graph = pg.optimize(gcfg, graph)
    after = graph.kf_poses[last]
    new_pose = compose(after, between(before, state.pose))
    gm = pg.regenerate_map(gcfg, model, graph, fresh_gm, beam=beam)
    return (
        graph, state.replace(gm=gm, pose=new_pose), total_new,
        graph.kf_poses[last],
    )


@partial(jax.jit, static_argnums=(0, 1))
def _densify_fn(gcfg, model, graph):
    return pg.densify_loops(gcfg, model, graph)


@partial(jax.jit, static_argnums=0)
def _optimize_fn(gcfg, graph):
    return pg.optimize(gcfg, graph)


@partial(jax.jit, static_argnums=(0, 1, 2))
def _regen_fn(gcfg, model, beam, graph, fresh_gm):
    return pg.regenerate_map(gcfg, model, graph, fresh_gm, beam=beam)


@partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _joint_refine_fn(gcfg, model, beam, rounds, graph, gm_template):
    return pg.joint_refine(
        gcfg, model, graph, gm_template, beam, rounds=rounds
    )


@dataclasses.dataclass(frozen=True)
class FullConfig:
    tracking: EngineConfig = None  # default filled in __post_init__
    graph: pg.PoseGraphConfig = pg.PoseGraphConfig()
    #: re-optimize + regenerate map every time this many loops accumulate
    optimize_every_loops: int = 1
    #: before each optimize, run ``posegraph.densify_loops`` this many times
    #: (each pass proposes up to graph.max_candidates new pair constraints
    #: between mid-trajectory keyframes; 0 disables)
    densify_rounds: int = 1
    #: after each optimize, polish every keyframe pose against the dense
    #: leave-one-out occupancy consensus (``posegraph.joint_refine``;
    #: 0 disables — it costs ~K map rasterizations per round)
    joint_refine_rounds: int = 0
    #: keyframes processed per jitted add+detect dispatch (keyframe work is
    #: batched to cut dispatches — see posegraph.process_keyframes)
    kf_batch: int = 8
    #: re-express not-yet-processed tracked poses in the optimized frame
    #: after each in-segment closure burst (r4 advisor finding: without
    #: it, keyframes added after a burst mix pre/post-optimize frames in
    #: chain edges and loop detection centers on stale poses). Kept as a
    #: knob because the correction also propagates the last-keyframe's
    #: optimization noise into subsequent keyframe placement — A/B'd on
    #: the 5-seed 2-lap ATE harness.
    burst_reexpress: bool = True
    #: fused path: device->host result syncs happen once per this many
    #: segments (anchors are computed on device, so the host only needs
    #: counters for capacity bookkeeping; deferring the fetch lets the
    #: segment dispatches pipeline through JAX's async queue instead of
    #: serializing on a host round trip per segment)
    sync_every: int = 4

    def __post_init__(self):
        if self.tracking is None:
            object.__setattr__(self, "tracking", tiny_config())


class FullSlamEngine:
    """Host driver for the loop-closing pipeline."""

    def __init__(self, cfg: FullConfig | None = None, n_beams: int = 360, key=None):
        self.cfg = cfg or FullConfig()
        t = self.cfg.tracking
        self.state: SlamState = init_state(t, key)
        self.graph: pg.PoseGraphState = pg.init_state(self.cfg.graph, n_beams)
        self.pending_loops = 0
        self.total_loops = 0
        self.trajectory: list = []
        #: per trajectory entry: (anchor keyframe idx, body-frame delta from
        #: that keyframe's estimate at record time) — lets loop closures
        #: retro-correct the whole history (reference only corrects the live
        #: map->odom transform; correcting history improves full-run ATE)
        self._anchors: list = []

        model = t.cell_model
        self._track = jax.jit(partial(slam_step, t))
        g = self.cfg.graph
        #: segment tracker with device-side keyframe gate (static gate
        #: params only — re-jit is NOT needed on graph capacity growth)
        self._track_seg = partial(
            track_segment, t, g.keyframe_distance, g.keyframe_angle_weight
        )
        #: device-resident last-keyframe pose for the in-segment gate
        self._last_kf_dev = jnp.asarray(_NO_KF, jnp.float32)
        #: device-resident trajectory-anchor pose (the fused path computes
        #: anchors on device; init mirrors the host bookkeeping's zeros)
        self._anchor_pose_dev = jnp.zeros(3, jnp.float32)
        #: host mirrors for anchor bookkeeping (no per-scan device sync)
        self._last_kf_pose_host = None
        self._n_kf_host = 0
        #: host upper bound on graph edges (worst case per event) so
        #: _ensure_capacity never reads device counters (a device sync per
        #: keyframe); the conservative bound can only grow EARLY
        self._edges_upper_host = 0
        #: loop detections accumulate on device; fetched once per segment
        self._loops_dev = jnp.int32(0)
        #: tail row of the last drained fused segment (anchor, last_kf,
        #: pending) — lets end-of-run bookkeeping ride the drain fetch
        self._last_tail = None
        self._rejit()

    def _rejit(self):
        """(Re)bind the graph-rate jitted functions against the current
        graph config — called at init and after every capacity growth.
        The jits themselves are module-level (shared cache across engine
        instances); this only refreshes the bound static args."""
        t = self.cfg.tracking
        model = t.cell_model
        g = self.cfg.graph
        self._kf_batch = partial(_kf_batch_fn, g, model)
        self._densify = partial(_densify_fn, g, model)
        self._optimize = partial(_optimize_fn, g)
        self._regen = partial(_regen_fn, g, model, t.beam)
        self._close_fused = partial(
            _close_burst_fn, g, model, t.beam, self.cfg.densify_rounds
        )

    def _ensure_capacity(self, n_new: int = 1):
        """Grow the graph (2x) BEFORE an add would saturate — the host-side
        re-shard event mirroring blockmap's contract, so long runs never
        silently stop building the graph (keyframes past the old capacity
        would previously be dropped and the regenerated map frozen)."""
        g = self.cfg.graph
        # worst case per keyframe: 1 odometric edge + max_candidates loop
        # edges + densify passes of max_candidates each. Host-side upper
        # bounds only — device counter reads would sync per keyframe.
        edge_budget = n_new * (
            1 + g.max_candidates * (1 + self.cfg.densify_rounds)
        )
        need_kf = self._n_kf_host + n_new > g.max_keyframes
        need_edges = self._edges_upper_host + edge_budget > g.max_edges
        if not (need_kf or need_edges):
            return

        def fit(cap, need):
            # doubling until the bound fits — one doubling is not enough
            # for the fused path, whose per-segment bound can exceed a
            # small initial capacity severalfold
            while cap < need:
                cap *= 2
            return cap

        new_cfg, self.graph = pg.grow(
            g, self.graph,
            max_keyframes=fit(g.max_keyframes, self._n_kf_host + n_new),
            max_edges=fit(g.max_edges, self._edges_upper_host + edge_budget),
        )
        self.cfg = dataclasses.replace(self.cfg, graph=new_cfg)
        self._rejit()

    def handle_scan(self, scan: LaserScan, odom_delta) -> jax.Array:
        """Online mode: one scan at a time (forces a per-scan sync — use
        :meth:`run` / :meth:`run_segments` for throughput)."""
        seg_scans = jax.tree.map(lambda a: a[None], scan)
        self.run_segments(seg_scans, jnp.asarray(odom_delta)[None], segment=1)
        return self.state.pose

    def run_segments(self, scans: LaserScan, odom, segment: int = 64):
        """Segmented pipeline: device-resident tracking in ``segment``-scan
        chunks (one host fetch per chunk), graph work at keyframe rate,
        loop closures applied at segment boundaries."""
        import numpy as np

        n = int(odom.shape[0])
        for s0 in range(0, n, segment):
            s1 = min(s0 + segment, n)
            seg_scans = jax.tree.map(lambda a: a[s0:s1], scans)
            seg_odom = odom[s0:s1]
            self.state, self._last_kf_dev, poses, flags = self._track_seg(
                self.state, self._last_kf_dev, seg_scans, seg_odom
            )
            # the ONE device->host sync of the segment
            poses_np = np.asarray(poses)
            flags_np = np.asarray(flags)

            # keyframe-rate graph work (add + loop detect; no optimize yet
            # so anchors below see the pre-optimize keyframe estimates,
            # matching the per-scan driver's recording order). Batched:
            # ONE jitted dispatch per kf_batch keyframes, ONE loop-count
            # sync per segment.
            kf_is = np.nonzero(flags_np)[0]
            kb = self.cfg.kf_batch
            for c0 in range(0, len(kf_is), kb):
                chunk = kf_is[c0:c0 + kb]
                self._ensure_capacity(len(chunk))
                idx = jnp.asarray(
                    np.pad(chunk, (0, kb - len(chunk))), jnp.int32
                )
                valid = jnp.asarray(np.arange(kb) < len(chunk))
                self.graph, self._loops_dev = self._kf_batch(
                    self.graph, self._loops_dev, seg_scans, poses, idx, valid
                )
                self._n_kf_host += len(chunk)
                self._edges_upper_host += (
                    (1 + self.cfg.graph.max_candidates) * len(chunk)
                )
            if len(kf_is):
                nl = int(self._loops_dev)  # the segment's ONE loop sync
                self._loops_dev = jnp.int32(0)
                self.pending_loops += nl
                self.total_loops += nl

            # anchor bookkeeping, fully host-side: each scan anchors to the
            # latest keyframe at its record time (its own, if flagged)
            s = s1 - s0
            cur_idx = max(self._n_kf_host - int(flags_np.sum()) - 1, 0)
            cur_pose = (
                self._last_kf_pose_host
                if self._last_kf_pose_host is not None
                else np.zeros(3, np.float32)
            )
            anchor_idx = np.empty(s, np.int64)
            anchor_pose = np.empty((s, 3), np.float32)
            kf_counter = self._n_kf_host - int(flags_np.sum())
            for i in range(s):
                if flags_np[i]:
                    cur_idx = kf_counter
                    kf_counter += 1
                    cur_pose = poses_np[i]
                anchor_idx[i] = cur_idx
                anchor_pose[i] = cur_pose
            deltas = _between_np(anchor_pose, poses_np)
            self._anchors.extend(
                (int(anchor_idx[i]), deltas[i]) for i in range(s)
            )
            self.trajectory.extend(poses_np)
            self._last_kf_pose_host = cur_pose

            if self.pending_loops >= self.cfg.optimize_every_loops:
                self._close_loops()
                self.pending_loops = 0
        return self.corrected_trajectory()

    def _drain_packed(self, pending_packed) -> None:
        """Fetch + fold the queued segments' packed results: trajectory,
        anchors (device-computed), counters. ONE concatenated device->host
        transfer for the whole queue."""
        import numpy as np

        if not pending_packed:
            return
        arrs = [p for p, _ in pending_packed]
        allp = np.asarray(
            jnp.concatenate(arrs, axis=0) if len(arrs) > 1 else arrs[0]
        )
        off = 0
        for _, s in pending_packed:
            rows = allp[off : off + s]
            counters = allp[off + s]
            tail = allp[off + s + 1]
            off += s + 2
            self.trajectory.extend(rows[:, :3])
            self._anchors.extend(
                (int(rows[i, 4]), rows[i, 5:8]) for i in range(s)
            )
            self.total_loops += int(counters[0])
            if counters[1] > 0.5:
                raise RuntimeError(
                    "pose-graph capacity overflow inside a fused segment "
                    "(keyframes or edges were dropped on device): either "
                    "the odometry-based keyframe bound or the per-burst "
                    "edge budget (ceil(keyframes/kf_batch) bursts x "
                    "densify_rounds x max_candidates edges) was "
                    "insufficient — raise PoseGraphConfig.max_keyframes/"
                    "max_edges or shorten the segment"
                )
            # resync the host bounds to the device actuals
            self._n_kf_host = int(counters[3])
            self._edges_upper_host = int(counters[4])
            # the tail row folds pending/anchor/last_kf into the SAME
            # fetch (separate int(pending)/np.asarray(anchor) syncs would
            # each cost a device round trip)
            self._last_tail = tail
        pending_packed.clear()

    def run_segments_fused(self, scans: LaserScan, odom, segment: int = 128):
        """Fully device-resident segments: ONE dispatch per segment
        (tracking + keyframe batches + conditional closure burst — see
        _segment_fused_fn), results fetched once per ``sync_every``
        segments (anchors are computed on device, so between syncs the
        host only advances conservative capacity bounds and the segment
        dispatches pipeline through the async queue). Every flagged scan
        is processed on-device before the burst (max_kf = segment), so
        the semantics match run_segments."""
        import numpy as np

        t = self.cfg.tracking
        g_pending = jnp.int32(self.pending_loops)
        n = int(odom.shape[0])
        pending_packed: list = []
        self._last_tail = None  # set by _drain_packed from the tail rows
        if self._last_kf_pose_host is not None:
            # pick up state left by the unfused path (they may interleave)
            self._anchor_pose_dev = jnp.asarray(
                self._last_kf_pose_host, jnp.float32
            )
        # fetch the WHOLE odometry once, before any dispatch: a per-segment
        # np.asarray(seg_odom) looks free (it's an input slice) but the
        # device stream orders it AFTER the previously queued segment, so
        # every loop iteration would silently wait for compute + a fetch
        od_all = np.asarray(odom)
        for si, s0 in enumerate(range(0, n, segment)):
            s1 = min(s0 + segment, n)
            max_kf = s1 - s0
            # capacity bound from the segment's odometric path length (a
            # keyframe needs >= keyframe_distance of travel): 2x + slack
            # covers matcher corrections. _n_kf_host/_edges_upper_host act
            # as conservative UPPER bounds between syncs (they resync to
            # device actuals at each drain); if a pathological segment
            # still overflows, the device latch fails loudly at the drain.
            g = self.cfg.graph
            od_np = od_all[s0:s1]
            seg_dist = float(
                np.linalg.norm(od_np[:, :2], axis=1).sum()
                + g.keyframe_angle_weight * np.abs(od_np[:, 2]).sum()
            )
            kf_bound = min(
                max_kf, int(2.0 * seg_dist / g.keyframe_distance) + 8
            )
            self._ensure_capacity(kf_bound)
            # the segment slices its scans INSIDE the jit from the full
            # device-resident sequence (traced offset): host-side pytree
            # slicing cost 4 extra device dispatches per segment (r5 fix,
            # see _segment_fused_fn docstring)
            (
                self.state, self._last_kf_dev, self._anchor_pose_dev,
                self.graph, g_pending, packed,
            ) = _segment_fused_fn(
                t, self.cfg.graph, self.cfg.densify_rounds,
                self.cfg.optimize_every_loops, max_kf, self.cfg.kf_batch,
                self.cfg.burst_reexpress,
                self.state, self._last_kf_dev, self._anchor_pose_dev,
                self.graph, g_pending, scans, odom, np.int32(s0),
            )
            pending_packed.append((packed, max_kf))
            # advance the conservative bounds (drain resyncs to actuals).
            # Bursts fire at keyframe-BATCH cadence, so a segment can run
            # up to ceil(kf_bound/kf_batch) bursts of densify_rounds *
            # max_candidates new edges each (r4 advisor finding: the
            # one-burst-per-segment budget under-reserved).
            n_bursts = -(-kf_bound // max(self.cfg.kf_batch, 1))
            self._n_kf_host += kf_bound
            self._edges_upper_host += kf_bound * (1 + g.max_candidates) + (
                n_bursts * self.cfg.densify_rounds * g.max_candidates
            )
            if (si + 1) % max(self.cfg.sync_every, 1) == 0:
                self._drain_packed(pending_packed)
        self._drain_packed(pending_packed)
        # pending/anchor/last_kf ride the LAST drained packed's tail row —
        # no extra device syncs at end-of-run (a fused one-segment run
        # costs dispatch + ONE fetch, the same event count as the
        # monolithic tracker)
        if self._last_tail is not None:
            tail = self._last_tail
            self.pending_loops = int(round(float(tail[6])))
            # keep the unfused path's host mirror consistent (handle_scan
            # and run_segments may interleave with fused runs)
            self._last_kf_pose_host = np.asarray(tail[0:3], np.float32)
        return self.corrected_trajectory()

    def _close_loops(self):
        """Optimize the graph, re-anchor the tracker, regenerate the map."""
        if self.cfg.joint_refine_rounds == 0:
            # fused fast path: densify + optimize + re-anchor + regen in
            # ONE dispatch, one loop-count sync
            fresh = gridlib.make_grid_map(
                self.cfg.tracking.cell_model,
                self.cfg.tracking.map_height,
                self.cfg.tracking.map_width,
                self.cfg.tracking.map_scale,
            )
            self.graph, self.state, total_new, last_pose = self._close_fused(
                self.graph, self.state, fresh
            )
            nl = int(total_new)
            self.total_loops += nl
            self._edges_upper_host += nl
            import numpy as np

            self._last_kf_pose_host = np.asarray(last_pose)
            self._last_kf_dev = jnp.asarray(self._last_kf_pose_host)
            return
        last = self.graph.last_kf
        before = self.graph.kf_poses[last]
        for _ in range(self.cfg.densify_rounds):
            self.graph, n_new = self._densify(self.graph)
            self.total_loops += int(n_new)
            self._edges_upper_host += int(n_new)
            if int(n_new) == 0:
                break
        self.graph = self._optimize(self.graph)
        if self.cfg.joint_refine_rounds > 0:
            t = self.cfg.tracking
            small = gridlib.make_grid_map(
                t.cell_model, t.map_height, t.map_width, t.map_scale
            )
            self.graph = _joint_refine_fn(
                self.cfg.graph, t.cell_model, t.beam,
                self.cfg.joint_refine_rounds, self.graph, small,
            )
        after = self.graph.kf_poses[last]
        # re-anchor tracking pose: keep the offset from the last keyframe
        new_pose = compose(after, between(before, self.state.pose))
        fresh = gridlib.make_grid_map(
            self.cfg.tracking.cell_model,
            self.cfg.tracking.map_height,
            self.cfg.tracking.map_width,
            self.cfg.tracking.map_scale,
        )
        gm = self._regen(self.graph, fresh)
        self.state = self.state.replace(gm=gm, pose=new_pose)
        import numpy as np

        self._last_kf_pose_host = np.asarray(self.graph.kf_poses[last])
        # keep the device-side gate consistent with the optimized keyframe
        self._last_kf_dev = jnp.asarray(self._last_kf_pose_host)

    def save_checkpoint(self, path: str) -> None:
        """Snapshot the WHOLE pipeline — device pytrees (tracker state,
        pose graph, keyframe-gate anchor) AND the host-side bookkeeping
        (trajectory anchors, counters) — as one npz. The engine states
        alone (utils.checkpoint) miss the host half: a resumed run would
        lose the corrected-trajectory history and the capacity/pending
        counters. Restore is bit-exact given the same config
        (tests/test_full_pipeline.py)."""
        import numpy as np

        from ..utils import checkpoint as ckpt

        dev = {
            "state": self.state,
            "graph": self.graph,
            "last_kf_dev": self._last_kf_dev,
            "anchor_pose_dev": self._anchor_pose_dev,
        }
        host = {
            "pending_loops": self.pending_loops,
            "total_loops": self.total_loops,
            "n_kf_host": self._n_kf_host,
            "edges_upper_host": self._edges_upper_host,
            "last_kf_pose_host": (
                None if self._last_kf_pose_host is None
                else np.asarray(self._last_kf_pose_host).tolist()
            ),
            "anchor_idx": [int(a[0]) for a in self._anchors],
        }
        ckpt.save(path, dev)
        anchor_deltas = (
            np.stack([a[1] for a in self._anchors])
            if self._anchors else np.zeros((0, 3), np.float32)
        )
        traj = (
            np.stack([np.asarray(p) for p in self.trajectory])
            if self.trajectory else np.zeros((0, 3), np.float32)
        )
        import json

        np.savez_compressed(
            path + ".host.npz", anchor_deltas=anchor_deltas, trajectory=traj,
            meta=np.frombuffer(json.dumps(host).encode(), np.uint8),
        )

    def restore_checkpoint(self, path: str) -> None:
        """Inverse of :meth:`save_checkpoint` (same config required)."""
        import json
        import os

        import numpy as np

        from ..utils import checkpoint as ckpt

        # validate BOTH halves exist before mutating any engine state: a
        # partially copied snapshot (or one written by an older build
        # without the host half) must not leave the engine half-restored
        # (r4 advisor finding)
        missing = [
            p for p in (path, path + ".host.npz")
            # utils.checkpoint appends .npz when absent from the dev path
            if not (os.path.exists(p) or os.path.exists(p + ".npz"))
        ]
        if missing:
            raise FileNotFoundError(
                f"full-pipeline checkpoint incomplete: missing {missing}; "
                "save_checkpoint writes BOTH the device pytree npz and the "
                "'.host.npz' bookkeeping half, and restore requires both "
                "(same FullConfig as at save time)"
            )
        dev = ckpt.restore(path, {
            "state": self.state,
            "graph": self.graph,
            "last_kf_dev": self._last_kf_dev,
            "anchor_pose_dev": self._anchor_pose_dev,
        })
        self.state = dev["state"]
        self.graph = dev["graph"]
        self._last_kf_dev = dev["last_kf_dev"]
        self._anchor_pose_dev = dev["anchor_pose_dev"]
        hostf = np.load(path + ".host.npz")
        host = json.loads(bytes(hostf["meta"]).decode())
        self.pending_loops = host["pending_loops"]
        self.total_loops = host["total_loops"]
        self._n_kf_host = host["n_kf_host"]
        self._edges_upper_host = host["edges_upper_host"]
        self._last_kf_pose_host = (
            None if host["last_kf_pose_host"] is None
            else np.asarray(host["last_kf_pose_host"], np.float32)
        )
        deltas = hostf["anchor_deltas"]
        self._anchors = [
            (idx, deltas[i]) for i, idx in enumerate(host["anchor_idx"])
        ]
        self.trajectory = list(hostf["trajectory"])

    def corrected_trajectory(self) -> jax.Array:
        """Trajectory history re-anchored to the CURRENT (optimized)
        keyframe estimates — the post-loop-closure trajectory.

        Host-side numpy on purpose: the anchors live in host lists, and a
        ``jnp.stack`` over 512 per-scan rows would compile a 512-operand
        device program. One kf_poses fetch + numpy compose is enough."""
        import numpy as np

        if not self._anchors:
            return jnp.zeros((0, 3))
        kf = np.asarray(self.graph.kf_poses)  # the ONE device fetch
        idx = np.asarray([a[0] for a in self._anchors], np.int64)
        deltas = np.stack([np.asarray(a[1]) for a in self._anchors])
        a = kf[idx]
        c, s = np.cos(a[:, 2]), np.sin(a[:, 2])
        x = a[:, 0] + c * deltas[:, 0] - s * deltas[:, 1]
        y = a[:, 1] + s * deltas[:, 0] + c * deltas[:, 1]
        raw = a[:, 2] + deltas[:, 2]
        th = np.arctan2(np.sin(raw), np.cos(raw))  # geometry.wrap_angle
        return jnp.asarray(
            np.stack([x, y, th], axis=-1).astype(np.float32)
        )

    def run(self, scans: LaserScan, odom, segment: int = 64):
        if self.cfg.joint_refine_rounds == 0:
            # one dispatch + one fetch per segment (the joint-refine pass
            # still runs host-side at closure rate on the unfused path)
            return self.run_segments_fused(scans, odom, segment=segment)
        return self.run_segments(scans, odom, segment=segment)

    @property
    def keyframe_poses(self):
        n = int(self.graph.n_kf)
        return self.graph.kf_poses[:n]

    @property
    def occupancy(self):
        return gridlib.occupancy_plane(self.state.gm, self.cfg.tracking.cell_model)
