"""Copy-on-write block-pool maps for the particle filter.

SURVEY.md §3.4/§7: the reference RBPF deep-copies whole per-particle maps on
resampling ("expensive copy"); the array-native answer is ONE shared block
pool + per-particle block *tables* with copy-on-write:

- resampling copies int32 tables (a gather of [P, TH, TW] indices) and
  recomputes block reference counts — map DATA never moves;
- before a particle writes a block it does not own exclusively
  (refcount > 1), the block is copied to a free pool slot and the table is
  repointed — all inside jit with fixed shapes (free slots are found by
  sorting the refcount==0 mask);
- converged particles share most blocks, so pool capacity tracks the
  number of DISTINCT blocks, not particles x map area.

Overflow (more distinct blocks needed than capacity) sets a flag the host
driver reacts to, mirroring dense-map growth events.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import struct
from . import grid as gridlib
from .cells import init_cell as _init_cell_of

Array = jax.Array


@struct.dataclass
class CowBlockMaps:
    pool: Array  # f32[N, B, B, C] shared blocks
    tables: Array  # i32[P, TH, TW] per-particle block table (-1 = default)
    refcnt: Array  # i32[N] references from all tables
    origin: Array  # f32[2]
    scale: float = struct.field(pytree_node=False)
    block: int = struct.field(pytree_node=False)
    overflow: Array = struct.field(default=None)  # bool[]

    @property
    def n_particles(self) -> int:
        return self.tables.shape[0]

    @property
    def capacity(self) -> int:
        return self.pool.shape[0]


def make_cow_maps(
    model,
    n_particles: int,
    tiles_h: int,
    tiles_w: int,
    capacity: int,
    block: int = 32,
    scale: float = 0.1,
    origin: tuple[float, float] | None = None,
) -> CowBlockMaps:
    c = model.n_channels + 1
    if origin is None:
        origin = (-tiles_w * block * scale / 2.0, -tiles_h * block * scale / 2.0)
    return CowBlockMaps(
        pool=jnp.broadcast_to(_init_cell_of(model), (capacity, block, block, c)).copy(),
        tables=jnp.full((n_particles, tiles_h, tiles_w), -1, jnp.int32),
        refcnt=jnp.zeros((capacity,), jnp.int32),
        origin=jnp.asarray(origin, jnp.float32),
        scale=float(scale),
        block=block,
        overflow=jnp.array(False),
    )


#: floor for the per-step (particle, tile) new-block budget; the effective
#: bound scales with the particle count (every particle can touch a fresh
#: O(10^2)-tile footprint on the SAME step — notably step 1, where nothing
#: is mapped yet), so a flat cap silently dropped allocations at high P.
MAX_WRITES_PER_STEP = 2048


def prepare_write(
    st: CowBlockMaps, model, touched: Array, max_writes: int | None = None
) -> CowBlockMaps:
    """Make every (particle, tile) in ``touched`` (bool[P, TH, TW])
    exclusively owned: allocate unmapped tiles, copy-on-write shared ones.

    Work is compacted to ``k_max`` entries (fixed shapes): the needed
    (particle, tile) pairs are brought to the front with one argsort, so
    block copies cost O(K) gathers, not O(P * tiles). ``k_max`` defaults to
    ``max(MAX_WRITES_PER_STEP, 96 * P)`` (clipped to P*T) — enough for
    every particle to claim a full scan footprint in one step; demand past
    it (or past the free-slot count) latches ``overflow`` and the excess
    writes are dropped, never misdirected.
    """
    p, th, tw = st.tables.shape
    t = th * tw
    n = st.capacity
    if max_writes is None:
        max_writes = max(MAX_WRITES_PER_STEP, 96 * p)
    k_max = min(max_writes, p * t)
    slot = st.tables.reshape(p * t)
    flat_touched = touched.reshape(p * t)

    mapped = slot >= 0
    shared = mapped & (jnp.take(st.refcnt, jnp.clip(slot, 0, n - 1)) > 1)
    need_new = flat_touched & (~mapped | shared)  # [P*T]
    k_needed = need_new.sum()

    # compact: indices of needed entries first (stable keeps order)
    sel = jnp.argsort(~need_new, stable=True)[:k_max]  # [K]
    sel_ok = need_new[sel]

    # free slots sorted ascending (refcnt == 0)
    free = st.refcnt == 0
    free_slots = jnp.argsort(~free, stable=True)  # [N], free first
    n_free = free.sum()
    overflow = st.overflow | (k_needed > jnp.minimum(n_free, k_max))

    dst = jnp.where(sel_ok, free_slots[jnp.clip(jnp.arange(k_max), 0, n - 1)], -1)
    src = jnp.where(sel_ok & shared[sel], slot[sel], -1)  # [K] cow sources

    # write updated table entries
    tables = slot.at[jnp.where(sel_ok, sel, p * t)].set(
        jnp.where(sel_ok, dst, -1), mode="drop"
    ).reshape(p, th, tw)

    # block copies: cow sources copy, fresh allocations reset to init
    init = _init_cell_of(model)
    blocks = jnp.where(
        (src >= 0)[:, None, None, None], st.pool[jnp.clip(src, 0, n - 1)], init
    )  # [K, B, B, C]
    pool = st.pool.at[jnp.where(dst >= 0, dst, n)].set(blocks, mode="drop")

    # refcounts: dec cow sources, inc new blocks
    dec = jnp.zeros((n,), jnp.int32).at[jnp.where(src >= 0, src, n)].add(1, mode="drop")
    inc = jnp.zeros((n,), jnp.int32).at[jnp.where(dst >= 0, dst, n)].add(1, mode="drop")
    refcnt = st.refcnt - dec + inc

    return st.replace(tables=tables, pool=pool, refcnt=refcnt, overflow=overflow)


def scatter_observations(
    st: CowBlockMaps, model, pid: Array, rows: Array, cols: Array, w: Array, s: Array
) -> CowBlockMaps:
    """Accumulate observations (flattened across particles) into the pool.

    pid/rows/cols/w/s: int32/float arrays of equal length; every touched
    (particle, tile) MUST already be exclusively owned (prepare_write).
    """
    b = st.block
    p, th, tw = st.tables.shape
    n = st.capacity
    tr, rr = rows // b, rows % b
    tc, cc = cols // b, cols % b
    ok = (
        (w > 0)
        & (tr >= 0) & (tr < th) & (tc >= 0) & (tc < tw)
        & (pid >= 0) & (pid < p)
    )
    slot = jnp.where(
        ok,
        st.tables[jnp.clip(pid, 0, p - 1), jnp.clip(tr, 0, th - 1), jnp.clip(tc, 0, tw - 1)],
        -1,
    )
    bb = b * b
    # drop sentinel must be OUT-OF-BOUNDS HIGH: negative scatter indices
    # WRAP in XLA (-1 lands on the last cell of the last block), so an
    # unmapped tile's observations would corrupt another particle's block
    lin = jnp.where(slot >= 0, slot * bb + rr * b + cc, n * bb)
    w_flat = jnp.zeros((n * bb,), jnp.float32).at[lin].add(
        jnp.where(ok, w, 0.0), mode="drop"
    )
    s_flat = jnp.zeros((n * bb,), jnp.float32).at[lin].add(
        jnp.where(ok, s, 0.0), mode="drop"
    )
    w_obs = w_flat.reshape(n, b, b)
    s_obs = s_flat.reshape(n, b, b)
    belief = st.pool[..., :-1]
    n_prev = st.pool[..., -1]
    new_belief = model.update(belief, n_prev, w_obs, s_obs)
    pool = jnp.concatenate([new_belief, (n_prev + w_obs)[..., None]], axis=-1)
    return st.replace(pool=pool)


def extract_window(
    st: CowBlockMaps, model, p: Array, center: Array, tiles_h: int, tiles_w: int
) -> gridlib.GridMap:
    """Dense window around ``center`` from particle ``p``'s map (the shared
    tile-window gather of blockmap.gather_window over this particle's
    table)."""
    from .blockmap import gather_window

    return gather_window(
        st.tables[p], st.pool, model, st.origin, st.scale, center,
        tiles_h, tiles_w,
    )


def resample(st: CowBlockMaps, idx: Array) -> CowBlockMaps:
    """Ancestor gather: copy TABLES only; recompute refcounts."""
    tables = st.tables[idx]
    n = st.capacity
    flat = tables.ravel()
    refcnt = jnp.zeros((n,), jnp.int32).at[jnp.where(flat >= 0, flat, n)].add(
        1, mode="drop"
    )
    return st.replace(tables=tables, refcnt=refcnt)


def distinct_blocks(st: CowBlockMaps) -> Array:
    return (st.refcnt > 0).sum()


def grow_pool(st: CowBlockMaps, model, new_capacity: int) -> CowBlockMaps:
    """Host-side pool growth (the CoW analogue of dense-map growth / the
    pose graph's grow): pad the shared pool with init blocks, extend the
    refcounts, clear the overflow latch. Tables are slot indices into the
    (prefix-preserved) pool, so they stay valid unchanged. Never call under
    jit — shapes change; a retrace follows."""
    assert new_capacity >= st.capacity
    n_new = new_capacity - st.capacity
    b, c = st.block, st.pool.shape[-1]
    pad = jnp.broadcast_to(_init_cell_of(model), (n_new, b, b, c))
    return st.replace(
        pool=jnp.concatenate([st.pool, pad], axis=0),
        refcnt=jnp.concatenate([st.refcnt, jnp.zeros((n_new,), jnp.int32)]),
        overflow=jnp.array(False),
    )
