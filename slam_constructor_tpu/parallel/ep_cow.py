"""EP-sharded copy-on-write particle maps: per-device block pools.

SURVEY.md §2.9 EP row: "per-particle maps = experts; route scan to each
particle's map shard" -> "particle-sharded block pools on separate
devices". The single-device CoW map (``ops/cow.py``) keeps ONE pool shared
by all particles; here the particle axis is split over a mesh axis and each
device owns a PRIVATE pool for its particle shard:

- Every per-scan op (window extraction for matching, write preparation,
  observation scatter) is device-local — no collectives on the scan path.
  Copy-on-write sharing happens within a shard.
- Only RESAMPLING crosses devices: a surviving particle may inherit its
  ancestor's map from another shard. ``ep_resample`` migrates blocks:
  tables (small int32) and pools are all_gathered, each device computes the
  set of GLOBAL blocks its new particles reference, deduplicates them with
  a fixed-size ``jnp.unique`` and compacts them into its local pool. Blocks
  whose descendants land on several devices are duplicated — that is the
  EP semantics (private pools), and still moves no data when ancestry
  stays on-device after weight convergence.

The all_gather of pools is the bandwidth worst case (equivalent to the
reference's resampling deep-copy, which copies every particle map);
a ppermute fetch of only-referenced blocks is the targeted optimization if
profiling shows resampling matters (it runs at Neff-collapse rate, not
every scan).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import struct
from ..ops import cow as cowlib
from ..ops import grid as gridlib

Array = jax.Array
_SENTINEL = 2_147_483_647  # int32 max: "no block" after global-id mapping


@struct.dataclass
class EpCowMaps:
    pool: Array  # f32[D, N, B, B, C] private per-device pools
    tables: Array  # i32[P, TH, TW] slot ids LOCAL to the owning shard
    refcnt: Array  # i32[D, N]
    origin: Array  # f32[2]
    overflow: Array  # bool[D]
    scale: float = struct.field(pytree_node=False)
    block: int = struct.field(pytree_node=False)

    @property
    def n_shards(self) -> int:
        return self.pool.shape[0]

    @property
    def n_particles(self) -> int:
        return self.tables.shape[0]


def make_ep_maps(
    model,
    n_particles: int,
    tiles_h: int,
    tiles_w: int,
    capacity_per_shard: int,
    n_shards: int,
    block: int = 32,
    scale: float = 0.1,
    origin: tuple[float, float] | None = None,
) -> EpCowMaps:
    assert n_particles % n_shards == 0, "particles must divide the mesh axis"
    c = model.n_channels + 1
    from ..ops.cells import init_cell

    init = init_cell(model)
    if origin is None:
        origin = (-tiles_w * block * scale / 2.0, -tiles_h * block * scale / 2.0)
    return EpCowMaps(
        pool=jnp.broadcast_to(
            init, (n_shards, capacity_per_shard, block, block, c)
        ).copy(),
        tables=jnp.full((n_particles, tiles_h, tiles_w), -1, jnp.int32),
        refcnt=jnp.zeros((n_shards, capacity_per_shard), jnp.int32),
        origin=jnp.asarray(origin, jnp.float32),
        overflow=jnp.zeros((n_shards,), bool),
        scale=float(scale),
        block=block,
    )


def state_sharding(st: EpCowMaps, mesh: Mesh, axis: str = "chips"):
    return st.replace(
        pool=NamedSharding(mesh, P(axis)),
        tables=NamedSharding(mesh, P(axis)),
        refcnt=NamedSharding(mesh, P(axis)),
        origin=NamedSharding(mesh, P()),
        overflow=NamedSharding(mesh, P(axis)),
    )


def place(st: EpCowMaps, mesh: Mesh, axis: str = "chips") -> EpCowMaps:
    return jax.tree.map(jax.device_put, st, state_sharding(st, mesh, axis))


def _local_cow(st: EpCowMaps, pool, tables, refcnt, overflow) -> cowlib.CowBlockMaps:
    return cowlib.CowBlockMaps(
        pool=pool,
        tables=tables,
        refcnt=refcnt,
        origin=st.origin,
        scale=st.scale,
        block=st.block,
        overflow=overflow,
    )


def ep_insert(
    st: EpCowMaps,
    model,
    pid: Array,  # i32[M] GLOBAL particle ids of flattened observations
    rows: Array,
    cols: Array,
    w: Array,
    s: Array,
    mesh: Mesh,
    axis: str = "chips",
) -> EpCowMaps:
    """Device-local CoW insertion: each shard keeps the observations whose
    particle it owns, prepares writes (allocate/copy) in its private pool,
    and scatters. No collectives."""
    p = st.n_particles
    p_local = p // mesh.shape[axis]
    th, tw = st.tables.shape[1:]
    b = st.block

    def kernel(pool, tables, refcnt, ovf, pid_, rows_, cols_, w_, s_):
        d = jax.lax.axis_index(axis)
        lpid = pid_ - d * p_local
        own = (lpid >= 0) & (lpid < p_local)
        w_own = jnp.where(own, w_, 0.0)
        lpid_c = jnp.clip(lpid, 0, p_local - 1)
        cm = _local_cow(st, pool[0], tables, refcnt[0], ovf[0])
        tr = jnp.clip(rows_ // b, 0, th - 1)
        tc = jnp.clip(cols_ // b, 0, tw - 1)
        ok = (
            (w_own > 0)
            & (rows_ >= 0) & (rows_ < th * b)
            & (cols_ >= 0) & (cols_ < tw * b)
        )
        touched = jnp.zeros((p_local, th, tw), bool).at[lpid_c, tr, tc].max(
            ok, mode="drop"
        )
        cm = cowlib.prepare_write(cm, model, touched)
        cm = cowlib.scatter_observations(
            cm, model, jnp.where(own, lpid_c, -1), rows_, cols_, w_own, s_
        )
        return cm.pool[None], cm.tables, cm.refcnt[None], cm.overflow[None]

    fn = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis),
                  P(None), P(None), P(None), P(None), P(None)),
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
        check_vma=False,
    )
    pool, tables, refcnt, overflow = fn(
        st.pool, st.tables, st.refcnt, st.overflow, pid, rows, cols, w, s
    )
    return st.replace(pool=pool, tables=tables, refcnt=refcnt, overflow=overflow)


def ep_resample(
    st: EpCowMaps, idx: Array, mesh: Mesh, axis: str = "chips"
) -> EpCowMaps:
    """Ancestor gather across shards: migrate referenced blocks to the
    descendants' devices and compact them into each private pool."""
    p = st.n_particles
    d_n = mesh.shape[axis]
    p_local = p // d_n
    n = st.pool.shape[1]
    th, tw = st.tables.shape[1:]

    def kernel(pool, tables, refcnt, ovf, idx_):
        d = jax.lax.axis_index(axis)
        tables_all = jax.lax.all_gather(tables, axis).reshape(p, th, tw)
        pools_all = jax.lax.all_gather(pool[0], axis)  # [D, N, B, B, C]

        my_ids = d * p_local + jnp.arange(p_local)
        anc = idx_[my_ids]  # [P/D] global ancestor ids
        anc_shard = anc // p_local
        t = tables_all[anc]  # [P/D, TH, TW] slots local to anc's shard
        gid = jnp.where(
            t >= 0, anc_shard[:, None, None] * n + t, _SENTINEL
        ).astype(jnp.int32)

        uq = jnp.unique(gid.ravel(), size=n + 1, fill_value=_SENTINEL)
        n_unique = (uq != _SENTINEL).sum()
        overflow = ovf[0] | (n_unique > n)
        uq_n = uq[:n]
        valid_slot = uq_n != _SENTINEL

        flat_pools = pools_all.reshape(d_n * n, *pool.shape[2:])
        init = jnp.zeros((flat_pools.shape[-1],))  # refcnt-0 slots: content irrelevant
        new_pool = jnp.where(
            valid_slot[:, None, None, None],
            flat_pools[jnp.clip(uq_n, 0, d_n * n - 1)],
            init,
        )

        pos = jnp.searchsorted(uq_n, gid)  # [P/D, TH, TW]
        pos_c = jnp.clip(pos, 0, n - 1)
        hit = (gid != _SENTINEL) & (uq_n[pos_c] == gid) & (pos < n)
        new_tables = jnp.where(hit, pos_c, -1).astype(jnp.int32)

        new_refcnt = (
            jnp.zeros((n,), jnp.int32)
            .at[jnp.where(hit, pos_c, n).ravel()]
            .add(1, mode="drop")
        )
        return new_pool[None], new_tables, new_refcnt[None], overflow[None]

    fn = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(None)),
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
        check_vma=False,
    )
    pool, tables, refcnt, overflow = fn(
        st.pool, st.tables, st.refcnt, st.overflow, idx
    )
    return st.replace(pool=pool, tables=tables, refcnt=refcnt, overflow=overflow)


def init_ep_state(cfg, n_shards: int, capacity_per_shard: int | None = None,
                  key=None):
    """GMappingState over EP-sharded pools (mirrors gmapping.init_state's
    cow branch; per-shard capacity defaults to tile_capacity / n_shards)."""
    from ..models.gmapping import GMappingState

    if key is None:
        key = jax.random.PRNGKey(0)
    p = cfg.n_particles
    cap = capacity_per_shard or max(cfg.tile_capacity // n_shards, 1)
    st = make_ep_maps(
        cfg.cell_model, p,
        tiles_h=cfg.map_height // cfg.tile_block,
        tiles_w=cfg.map_width // cfg.tile_block,
        capacity_per_shard=cap,
        n_shards=n_shards,
        block=cfg.tile_block,
        scale=cfg.map_scale,
    )
    return GMappingState(
        gm=st,
        poses=jnp.zeros((p, 3), jnp.float32),
        log_weights=jnp.full((p,), -jnp.log(float(p))),
        key=key,
        step=jnp.int32(0),
    )


def make_ep_match(cfg, mesh: Mesh, axis: str = "chips"):
    """Per-particle scan matching against EP-local maps: each device
    extracts windows from its private pool and matches its particle shard
    (the EP 'route the scan to each expert's shard' dispatch).

    Runs :func:`models.gmapping.match_particle` per particle — the SAME
    pipeline (proposal mode, optional refine pass, minimumScore gate) and
    per-particle keys as the single-device step, so every GMappingConfig
    stays sharded/unsharded-equivalent (round-3 ADVICE: the old 'odom'-only
    guard silently ignored refine_matcher/min_match_prob).
    Returns ``(poses f32[P,3], log-weight increments f32[P])``."""
    from ..ops import scoring
    from ..models.gmapping import match_particle

    p = cfg.n_particles
    wt = cfg.window_tiles

    def ep_match(st: EpCowMaps, scan, priors: Array, centers: Array,
                 sigma: Array, k_match: Array):
        p_local = p // mesh.shape[axis]

        def kernel(pool, tables, refcnt, ovf, scan_, priors_, centers_,
                   sigma_, kmatch_):
            d = jax.lax.axis_index(axis)
            cm = _local_cow(st, pool[0], tables, refcnt[0], ovf[0])
            keys = jax.random.split(kmatch_, p)  # same split on every shard

            def one(li):
                g = d * p_local + li
                prior = priors_[g]
                win = cowlib.extract_window(cm, cfg.cell_model, li, prior[:2], wt, wt)
                view = scoring.MapView.of(win, cfg.cell_model)
                return match_particle(
                    cfg, view, scan_, prior, centers_[g], sigma_, keys[g]
                )

            return jax.vmap(one)(jnp.arange(p_local))

        fn = shard_map(
            kernel,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis),
                      P(None), P(None), P(None), P(None), P(None)),
            out_specs=(P(axis), P(axis)),
            check_vma=False,
        )
        return fn(st.pool, st.tables, st.refcnt, st.overflow, scan, priors,
                  centers, sigma, k_match)

    return ep_match


def make_ep_step(cfg, mesh: Mesh, axis: str = "chips"):
    """Full RBPF step over EP-sharded CoW pools (mirrors the cow branch of
    ``models/gmapping.gmapping_step`` — same PRNG key discipline, so the
    trajectory statistics match the single-device step): propose (replicated)
    -> match (EP shard_map) -> weight (replicated normalize) -> insert
    (device-local) -> resample (cross-shard block migration)."""
    from functools import partial

    from ..ops import raycast, resample
    from ..ops.geometry import compose
    from ..models.gmapping import GMappingState

    p = cfg.n_particles
    model = cfg.cell_model

    def step(state: GMappingState, scan, odom_delta: Array):
        st: EpCowMaps = state.gm
        key, k_noise, k_match, k_res = jax.random.split(state.key, 4)

        base = jnp.array([cfg.noise_xy, cfg.noise_xy, cfg.noise_theta])
        alpha = jnp.array([cfg.alpha_xy, cfg.alpha_xy, cfg.alpha_theta])
        sigma = base + alpha * jnp.abs(odom_delta)
        noise = jax.random.normal(k_noise, (p, 3)) * sigma
        priors = compose(state.poses, odom_delta[None, :] + noise)
        centers = compose(state.poses, jnp.broadcast_to(odom_delta, (p, 3)))

        poses, incr = make_ep_match(cfg, mesh, axis)(
            st, scan, priors, centers, sigma, k_match
        )

        logw = resample.normalize_log_weights(state.log_weights + incr)

        rows, cols, w, s = jax.vmap(
            lambda pose_p: raycast.scan_sample_cells(
                st.origin, st.scale, pose_p, scan, cfg.beam
            )
        )(poses)
        pid = jnp.broadcast_to(jnp.arange(p)[:, None], rows.shape)
        st = ep_insert(
            st, model, pid.ravel(), rows.ravel(), cols.ravel(),
            w.ravel(), s.ravel(), mesh, axis,
        )

        idx, logw, did = resample.maybe_resample(k_res, logw, cfg.resample_threshold)
        # ep_resample all_gathers every shard's full pool — the bandwidth
        # worst case — so it runs ONLY when resampling actually fired
        # (identity idx is a semantic no-op); this keeps the scan path free
        # of collectives as the module contract promises
        st = jax.lax.cond(
            did,
            lambda s: ep_resample(s, idx, mesh, axis),
            lambda s: s,
            st,
        )
        poses = poses[idx]
        return (
            GMappingState(
                gm=st, poses=poses, log_weights=logw, key=key,
                step=state.step + 1,
            ),
            idx,
        )

    return jax.jit(step, donate_argnums=0)


def gather_planes(
    st: EpCowMaps, model, mesh: Mesh, axis: str = "chips"
) -> Array:
    """Dense occupancy-value planes for every particle [P, H, W] (tests /
    export; each shard densifies its local particles)."""
    p = st.n_particles
    p_local = p // mesh.shape[axis]
    th, tw = st.tables.shape[1:]

    def kernel(pool, tables, refcnt, ovf):
        cm = _local_cow(st, pool[0], tables, refcnt[0], ovf[0])

        def one(i):
            # full-extent window: offsets clip to 0 when the request spans
            # the whole table, so any center works
            gm = cowlib.extract_window(cm, model, i, jnp.zeros(2), th, tw)
            occ = gridlib.occupancy_plane(gm, model)
            known = gridlib.known_mask(gm)
            return jnp.where(known, occ, 0.5)

        return jax.vmap(one)(jnp.arange(p_local))

    fn = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    return fn(st.pool, st.tables, st.refcnt, st.overflow)
