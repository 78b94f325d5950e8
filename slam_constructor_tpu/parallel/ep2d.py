"""EP x TP composition: particle-sharded CoW pools x tile-band map sharding
on one 2D device mesh ``("pgroups", "bands")``.

SURVEY.md §2.9 composes the EP row (per-particle maps = experts, particle
axis over devices — ``parallel/ep_cow.py``) with the TP row (map block-table
bands over devices — ``parallel/blockshard.py``). Round-2 verdict missing
item #5 / task 8: large multi-host RBPF maps need BOTH — more particles
than one device group can hold maps for, AND maps bigger than one device's
pool. Device ``(g, b)`` owns, for the particles of group ``g``, a PRIVATE
pool holding only the blocks of tile-row band ``b``:

- ``pool f32[Dp, Db, N, B, B, C]``; ``tables i32[P, TH, TW]`` sharded
  ``P("pgroups", "bands", None)`` — slot ids are LOCAL to the owning
  ``(group, band)`` pool.
- **Insertion is fully local** (the EP promise survives the composition):
  a device keeps the observation samples that hit its particles AND its
  band rows; allocation/copy-on-write run against the private pool.
- **Matching windows are assembled with one ``psum`` over the "bands"
  axis**: each band contributes the window tiles it owns (zeros
  elsewhere), the sum is the complete dense window, and the per-particle
  match then runs band-replicated (windows are small — wt*B per side —
  so the replicated FLOPs are noise next to the scoring matmuls; the
  psum stays inside the host). This is the block-halo analogue for windows that
  straddle band boundaries.
- **Resampling migrates blocks across particle groups WITHIN each band**
  (``all_gather`` over "pgroups" only): ancestry moves whole maps, but a
  band's rows stay in that band, so the band axis never communicates at
  resample time.

Golden-tested against the single-device shared-pool CoW RBPF step
(tests/test_parallel.py::test_ep2d_gmapping_step_matches_unsharded_cow).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import struct
from ..ops import cow as cowlib
from ..ops import grid as gridlib
from ..ops.cells import init_cell

Array = jax.Array
_SENTINEL = 2_147_483_647


@struct.dataclass
class Ep2dMaps:
    pool: Array  # f32[Dp, Db, N, B, B, C]
    tables: Array  # i32[P, TH, TW] slots local to (owner group, band)
    refcnt: Array  # i32[Dp, Db, N]
    origin: Array  # f32[2]
    overflow: Array  # bool[Dp, Db]
    scale: float = struct.field(pytree_node=False)
    block: int = struct.field(pytree_node=False)

    @property
    def n_particles(self) -> int:
        return self.tables.shape[0]


def make_ep2d_maps(
    model,
    n_particles: int,
    tiles_h: int,
    tiles_w: int,
    capacity_per_device: int,
    n_pgroups: int,
    n_bands: int,
    block: int = 32,
    scale: float = 0.1,
    origin: tuple[float, float] | None = None,
) -> Ep2dMaps:
    assert n_particles % n_pgroups == 0, "particles must divide pgroups"
    assert tiles_h % n_bands == 0, "tile rows must divide bands"
    c = model.n_channels + 1
    init = init_cell(model)
    if origin is None:
        origin = (-tiles_w * block * scale / 2.0, -tiles_h * block * scale / 2.0)
    return Ep2dMaps(
        pool=jnp.broadcast_to(
            init, (n_pgroups, n_bands, capacity_per_device, block, block, c)
        ).copy(),
        tables=jnp.full((n_particles, tiles_h, tiles_w), -1, jnp.int32),
        refcnt=jnp.zeros((n_pgroups, n_bands, capacity_per_device), jnp.int32),
        origin=jnp.asarray(origin, jnp.float32),
        overflow=jnp.zeros((n_pgroups, n_bands), bool),
        scale=float(scale),
        block=block,
    )


def state_sharding(st: Ep2dMaps, mesh: Mesh):
    return st.replace(
        pool=NamedSharding(mesh, P("pgroups", "bands")),
        tables=NamedSharding(mesh, P("pgroups", "bands", None)),
        refcnt=NamedSharding(mesh, P("pgroups", "bands")),
        origin=NamedSharding(mesh, P()),
        overflow=NamedSharding(mesh, P("pgroups", "bands")),
    )


def place(st: Ep2dMaps, mesh: Mesh) -> Ep2dMaps:
    return jax.tree.map(jax.device_put, st, state_sharding(st, mesh))


def _local_cow(st: Ep2dMaps, pool, tables, refcnt, overflow, row0) -> cowlib.CowBlockMaps:
    """Band-local view: a CowBlockMaps over this device's band rows (origin
    shifted up by the band's first cell row)."""
    return cowlib.CowBlockMaps(
        pool=pool,
        tables=tables,
        refcnt=refcnt,
        origin=st.origin
        + jnp.stack([jnp.float32(0.0), row0.astype(jnp.float32) * st.scale]),
        scale=st.scale,
        block=st.block,
        overflow=overflow,
    )


def ep2d_insert(
    st: Ep2dMaps,
    model,
    pid: Array,  # i32[M] GLOBAL particle ids of flattened observations
    rows: Array,  # i32[M] GLOBAL cell rows
    cols: Array,
    w: Array,
    s: Array,
    mesh: Mesh,
) -> Ep2dMaps:
    """Fully device-local insertion: keep samples owned by (my particles,
    my band rows); allocate/CoW/scatter in the private pool. No collectives."""
    p = st.n_particles
    dp, db_n = mesh.shape["pgroups"], mesh.shape["bands"]
    p_local = p // dp
    th, tw = st.tables.shape[1:]
    thl = th // db_n
    b = st.block
    band_rows = thl * b

    def kernel(pool, tables, refcnt, ovf, pid_, rows_, cols_, w_, s_):
        g = jax.lax.axis_index("pgroups")
        band = jax.lax.axis_index("bands")
        row0 = band * band_rows
        lpid = pid_ - g * p_local
        own_p = (lpid >= 0) & (lpid < p_local)
        lrows = rows_ - row0
        own_r = (lrows >= 0) & (lrows < band_rows)
        w_own = jnp.where(own_p & own_r, w_, 0.0)
        lpid_c = jnp.clip(lpid, 0, p_local - 1)
        cm = _local_cow(st, pool[0, 0], tables, refcnt[0, 0], ovf[0, 0], row0)
        tr = jnp.clip(lrows // b, 0, thl - 1)
        tc = jnp.clip(cols_ // b, 0, tw - 1)
        ok = (
            (w_own > 0)
            & (cols_ >= 0) & (cols_ < tw * b)
        )
        touched = jnp.zeros((p_local, thl, tw), bool).at[lpid_c, tr, tc].max(
            ok, mode="drop"
        )
        cm = cowlib.prepare_write(cm, model, touched)
        cm = cowlib.scatter_observations(
            cm, model, jnp.where(own_p, lpid_c, -1), lrows, cols_, w_own, s_
        )
        return (
            cm.pool[None, None],
            cm.tables,
            cm.refcnt[None, None],
            cm.overflow[None, None],
        )

    fn = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(
            P("pgroups", "bands"), P("pgroups", "bands", None),
            P("pgroups", "bands"), P("pgroups", "bands"),
            P(None), P(None), P(None), P(None), P(None),
        ),
        out_specs=(
            P("pgroups", "bands"), P("pgroups", "bands", None),
            P("pgroups", "bands"), P("pgroups", "bands"),
        ),
        check_vma=False,
    )
    pool, tables, refcnt, overflow = fn(
        st.pool, st.tables, st.refcnt, st.overflow, pid, rows, cols, w, s
    )
    return st.replace(pool=pool, tables=tables, refcnt=refcnt, overflow=overflow)


def _band_window_contrib(
    st: Ep2dMaps, model, tables_p, pool, band, center, wt: int
):
    """One band's additive contribution to particle p's dense window: the
    window tiles this band owns (init cell where unallocated), ZERO rows for
    tiles owned by other bands — so a psum over "bands" is the exact window."""
    b = st.block
    thl, tw = tables_p.shape
    db_n = st.tables.shape[1] // thl
    th = thl * db_n
    n = pool.shape[0]
    ct = gridlib.world_to_cell(
        gridlib.GridMap(cells=jnp.zeros((1, 1, 1)), origin=st.origin, scale=st.scale),
        center,
    )
    t0r = jnp.clip(ct[..., 0] // b - wt // 2, 0, max(th - wt, 0))
    t0c = jnp.clip(ct[..., 1] // b - wt // 2, 0, max(tw - wt, 0))
    tr = t0r + jnp.arange(wt)  # global tile rows of the window
    tc = t0c + jnp.arange(wt)
    ltr = tr - band * thl
    own = (ltr >= 0) & (ltr < thl)
    slots = tables_p[jnp.clip(ltr, 0, thl - 1)[:, None], tc[None, :]]
    sel = pool[jnp.clip(slots, 0, n - 1)]  # [wt, wt, B, B, C]
    init = init_cell(model)
    owned = own[:, None, None, None, None]
    blocks = jnp.where(
        owned & (slots >= 0)[..., None, None, None],
        sel,
        jnp.where(owned, init, jnp.zeros_like(init)),
    )
    dense = blocks.transpose(0, 2, 1, 3, 4).reshape(wt * b, wt * b, -1)
    w_origin = st.origin + jnp.stack(
        [t0c.astype(jnp.float32), t0r.astype(jnp.float32)]
    ) * (b * st.scale)
    return dense, w_origin


def make_ep2d_match(cfg, mesh: Mesh):
    """Per-particle matching: windows psum-assembled over "bands", matching
    band-replicated, results sharded over "pgroups".

    Band-replicated matching runs :func:`models.gmapping.match_particle`
    (same proposal / refine / minimumScore pipeline and keys as the
    single-device step) over the psum-assembled windows, so every
    GMappingConfig stays sharded/unsharded-equivalent. Returns
    ``(poses f32[P,3], log-weight increments f32[P])``."""
    from ..ops import scoring
    from ..models.gmapping import match_particle

    p = cfg.n_particles
    wt = cfg.window_tiles

    def ep2d_match(st: Ep2dMaps, scan, priors: Array, centers: Array,
                   sigma: Array, k_match: Array):
        p_local = p // mesh.shape["pgroups"]

        def kernel(pool, tables, refcnt, ovf, scan_, priors_, centers_,
                   sigma_, kmatch_):
            g = jax.lax.axis_index("pgroups")
            band = jax.lax.axis_index("bands")
            keys = jax.random.split(kmatch_, p)  # same split on every shard

            def window_of(li):
                gid = g * p_local + li
                return _band_window_contrib(
                    st, cfg.cell_model, tables[li], pool[0, 0], band,
                    priors_[gid][:2], wt,
                )

            dense, w_origin = jax.vmap(window_of)(jnp.arange(p_local))
            dense = jax.lax.psum(dense, "bands")  # complete windows

            def one(li):
                gid = g * p_local + li
                gm = gridlib.GridMap(
                    cells=dense[li], origin=w_origin[li], scale=st.scale
                )
                view = scoring.MapView.of(gm, cfg.cell_model)
                return match_particle(
                    cfg, view, scan_, priors_[gid], centers_[gid], sigma_,
                    keys[gid],
                )

            return jax.vmap(one)(jnp.arange(p_local))

        fn = shard_map(
            kernel,
            mesh=mesh,
            in_specs=(
                P("pgroups", "bands"), P("pgroups", "bands", None),
                P("pgroups", "bands"), P("pgroups", "bands"),
                P(None), P(None), P(None), P(None), P(None),
            ),
            # identical across "bands" by construction (replicated matching
            # over psum'd windows); sharded over particle groups
            out_specs=(P("pgroups"), P("pgroups")),
            check_vma=False,
        )
        return fn(
            st.pool, st.tables, st.refcnt, st.overflow, scan, priors,
            centers, sigma, k_match,
        )

    return ep2d_match


def ep2d_resample(st: Ep2dMaps, idx: Array, mesh: Mesh) -> Ep2dMaps:
    """Ancestor gather: per band, migrate referenced blocks across particle
    groups (all_gather over "pgroups" only — bands never exchange blocks;
    a band's rows stay in that band under any ancestry)."""
    p = st.n_particles
    dp = mesh.shape["pgroups"]
    p_local = p // dp
    n = st.pool.shape[2]
    th, tw = st.tables.shape[1:]
    thl = th // mesh.shape["bands"]

    def kernel(pool, tables, refcnt, ovf, idx_):
        g = jax.lax.axis_index("pgroups")
        tables_all = jax.lax.all_gather(tables, "pgroups").reshape(p, thl, tw)
        pools_all = jax.lax.all_gather(pool[0, 0], "pgroups")  # [Dp, N, ...]

        my_ids = g * p_local + jnp.arange(p_local)
        anc = idx_[my_ids]
        anc_group = anc // p_local
        t = tables_all[anc]  # [P/Dp, THl, TW] slots local to (anc group, band)
        gid = jnp.where(
            t >= 0, anc_group[:, None, None] * n + t, _SENTINEL
        ).astype(jnp.int32)

        uq = jnp.unique(gid.ravel(), size=n + 1, fill_value=_SENTINEL)
        n_unique = (uq != _SENTINEL).sum()
        overflow = ovf[0, 0] | (n_unique > n)
        uq_n = uq[:n]
        valid_slot = uq_n != _SENTINEL

        flat_pools = pools_all.reshape(dp * n, *pool.shape[3:])
        init = jnp.zeros((flat_pools.shape[-1],))
        new_pool = jnp.where(
            valid_slot[:, None, None, None],
            flat_pools[jnp.clip(uq_n, 0, dp * n - 1)],
            init,
        )

        pos = jnp.searchsorted(uq_n, gid)
        pos_c = jnp.clip(pos, 0, n - 1)
        hit = (gid != _SENTINEL) & (uq_n[pos_c] == gid) & (pos < n)
        new_tables = jnp.where(hit, pos_c, -1).astype(jnp.int32)

        new_refcnt = (
            jnp.zeros((n,), jnp.int32)
            .at[jnp.where(hit, pos_c, n).ravel()]
            .add(1, mode="drop")
        )
        return (
            new_pool[None, None],
            new_tables,
            new_refcnt[None, None],
            overflow[None, None],
        )

    fn = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(
            P("pgroups", "bands"), P("pgroups", "bands", None),
            P("pgroups", "bands"), P("pgroups", "bands"), P(None),
        ),
        out_specs=(
            P("pgroups", "bands"), P("pgroups", "bands", None),
            P("pgroups", "bands"), P("pgroups", "bands"),
        ),
        check_vma=False,
    )
    pool, tables, refcnt, overflow = fn(
        st.pool, st.tables, st.refcnt, st.overflow, idx
    )
    return st.replace(pool=pool, tables=tables, refcnt=refcnt, overflow=overflow)


def init_ep2d_state(cfg, n_pgroups: int, n_bands: int,
                    capacity_per_device: int | None = None, key=None):
    """GMappingState over the composed mesh (mirrors ep_cow.init_ep_state)."""
    from ..models.gmapping import GMappingState

    if key is None:
        key = jax.random.PRNGKey(0)
    p = cfg.n_particles
    cap = capacity_per_device or max(
        cfg.tile_capacity // (n_pgroups * n_bands), 1
    )
    st = make_ep2d_maps(
        cfg.cell_model, p,
        tiles_h=cfg.map_height // cfg.tile_block,
        tiles_w=cfg.map_width // cfg.tile_block,
        capacity_per_device=cap,
        n_pgroups=n_pgroups,
        n_bands=n_bands,
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


def make_ep2d_step(cfg, mesh: Mesh):
    """Full RBPF step over the composed mesh — the same PRNG/weight
    discipline as gmapping_step's cow branch and ep_cow.make_ep_step, so
    trajectories golden-match the single-device step."""
    from ..ops import raycast, resample
    from ..ops.geometry import compose
    from ..models.gmapping import GMappingState

    p = cfg.n_particles
    model = cfg.cell_model
    match = make_ep2d_match(cfg, mesh)

    def step(state: GMappingState, scan, odom_delta: Array):
        st: Ep2dMaps = state.gm
        key, k_noise, k_match, k_res = jax.random.split(state.key, 4)

        base = jnp.array([cfg.noise_xy, cfg.noise_xy, cfg.noise_theta])
        alpha = jnp.array([cfg.alpha_xy, cfg.alpha_xy, cfg.alpha_theta])
        sigma = base + alpha * jnp.abs(odom_delta)
        noise = jax.random.normal(k_noise, (p, 3)) * sigma
        priors = compose(state.poses, odom_delta[None, :] + noise)
        centers = compose(state.poses, jnp.broadcast_to(odom_delta, (p, 3)))

        poses, incr = match(st, scan, priors, centers, sigma, k_match)

        logw = resample.normalize_log_weights(state.log_weights + incr)

        rows, cols, w, s = jax.vmap(
            lambda pose_p: raycast.scan_sample_cells(
                st.origin, st.scale, pose_p, scan, cfg.beam
            )
        )(poses)
        pid = jnp.broadcast_to(jnp.arange(p)[:, None], rows.shape)
        st = ep2d_insert(
            st, model, pid.ravel(), rows.ravel(), cols.ravel(),
            w.ravel(), s.ravel(), mesh,
        )

        idx, logw, did = resample.maybe_resample(
            k_res, logw, cfg.resample_threshold
        )
        st = jax.lax.cond(
            did,
            lambda s_: ep2d_resample(s_, idx, mesh),
            lambda s_: s_,
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


def gather_planes(st: Ep2dMaps, model, mesh: Mesh) -> Array:
    """Dense occupancy-value planes [P, H, W] (tests / export): each device
    densifies its band rows of its particles; bands stack along H."""
    p = st.n_particles
    p_local = p // mesh.shape["pgroups"]
    th, tw = st.tables.shape[1:]
    thl = th // mesh.shape["bands"]
    b = st.block

    def kernel(pool, tables, refcnt, ovf):
        n = pool.shape[2]
        init = init_cell(model)

        def one(li):
            slots = tables[li]  # [THl, TW]
            blocks = jnp.where(
                (slots >= 0)[..., None, None, None],
                pool[0, 0][jnp.clip(slots, 0, n - 1)],
                init,
            )
            dense = blocks.transpose(0, 2, 1, 3, 4).reshape(thl * b, tw * b, -1)
            occ = model.occupancy(dense[..., :-1])
            known = dense[..., -1] > 0.0
            return jnp.where(known, occ, 0.5)

        return jax.vmap(one)(jnp.arange(p_local))

    fn = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(
            P("pgroups", "bands"), P("pgroups", "bands", None),
            P("pgroups", "bands"), P("pgroups", "bands"),
        ),
        out_specs=P("pgroups", "bands", None),
        check_vma=False,
    )
    return fn(st.pool, st.tables, st.refcnt, st.overflow)
