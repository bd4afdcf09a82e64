"""Distributed multiway joins on a device mesh (``torch.distributed``).

The paper's on-chip network routing maps 1:1 onto mesh collectives:

  Plasticine                          device mesh ("row" × "col")
  ---------------------------------   --------------------------------------
  route r(a,b) → PMU[h(a), g(b)]      two-phase all_to_all (rows, then cols)
  broadcast s(b,c) down column g(b)   all_to_all to column + all_gather rows
  broadcast t(c,a) across row h(a)    all_to_all to row + all_gather cols
  per-PMU bucket join                 per-rank core join (the fused kernels)
  merge partial aggregates            all_reduce (counts) / OR (FM sketches)

Each rank is one process that holds its own stripe of every relation, in
arrival order (``shard_relation``: the rank at mesh position (i, j) holds
rows [k·L, (k+1)·L) with k = i·ncol + j, the "DRAM-resident, evenly
striped" state); the shuffle phases above are the partitioning the paper
configures the accelerator to perform first (§4).  The mesh is a
``DeviceMesh`` with two named dims (``make_mesh``): NCCL on the card, one
card a rank, and gloo on the CPU.  ``mesh.get_group(row)`` is an axis: the
ranks that share this rank's column index, in row order.

Everything is static-shape: the shuffles use fixed-capacity per-destination
send buffers of the same capacity on every rank (``all_to_all_single`` with
equal splits), and overflow is reduced and reported, never hidden.

Every rank takes every decision
-------------------------------
The program is multi-controller: no process sees a global array.  Every
host decision (the kind a query binds to, whether a round's shuffle
overflowed, which ranks re-run, the final round's capacities) is taken by
every rank from values reduced over the whole mesh, so all ranks take the
same branch and enter the same collectives; a rank that diverged would
leave the others waiting until the groups' ``timeout``.

Cross-device skew recovery
--------------------------
``engine_count_sharded`` extends the fused one-shot joins with the same
round contract as ``core.recovery``, lifted to the mesh: each round joins
every rank's share with a salted local plan and sums the partial counts of
overflow-free ranks (the "kept exact partials"); the per-rank overflow
bitmap is all-gathered to ``[nrow, ncol]``.  Each rank masks its stripe of
the driving relation down to the rows whose mesh position (a pure
function of the join keys, computed on the device) overflowed, and the
next round re-runs only those across the whole mesh with grown capacities
and a fresh salt.  A round whose shuffle overflowed anywhere is discarded
and retried with roomier buffers.  The final round sizes every shuffle
buffer to accept-all and every local bucket from its exact histogram (each
rank's bincount, summed over the mesh), so it cannot overflow:
``overflowed == False`` is a guarantee, not a flag.

Counts are int64 from the fused kernels' per-cell partials up: a rank's
kept partial is gathered as int64, so neither it nor the total wraps at
2^31 (the JAX package psums 16-bit limbs of an int32 partial, which wraps
once one device's partial passes 2^31).

Declarative entry: ``session.JoinSession.execute_sharded(query, mesh, row,
col)`` classifies the query on its mesh-wide cardinalities, re-keys the
relations to the canonical routing columns via the binding, and dispatches
here — the ``kind=`` string below is the internal dispatch key, not user
API.
"""

from __future__ import annotations

import datetime
import functools
import math
from typing import Mapping, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import cyclic3, engine, hashing, linear3, partition, star3
from repro_torch.core.recovery import exact_cap
from repro_torch.core.relation import Relation, resolve_device

# The collective backend a mesh's device type takes; there is no other.
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


class DistJoinResult(NamedTuple):
    count: torch.Tensor       # () int64, global
    overflowed: torch.Tensor  # () bool, any shuffle/bucket overflow anywhere


class DistEngineResult(NamedTuple):
    count: np.int64           # exact global count (int64)
    overflowed: bool          # False by construction
    rounds: int               # recovery rounds executed (1 = no skew)


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------

def make_mesh(rows: int, cols: int, row: str = "row", col: str = "col", *,
              device=None, timeout: float = 600.0):
    """A ``rows × cols`` ``DeviceMesh`` with dims named ``(row, col)`` over
    the default process group, whose world size must be ``rows * cols``.

    ``device=None`` means the card: NCCL, one card a rank (each rank sets
    its card with ``torch.cuda.set_device`` first).  ``device="cpu"``
    gives gloo.  Without CUDA, ``device=None`` raises and names
    ``device="cpu"``; a CUDA mesh never falls back to gloo.  Every rank
    calls this after ``torch.distributed.init_process_group``.  Both axes'
    process groups wait at most ``timeout`` seconds in a collective, so a
    rank that diverges fails the others instead of hanging them.
    """
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if dev.type not in _BACKENDS:
        raise ValueError(f"no mesh backend for device {dev}; use \"cuda\" "
                         "(NCCL) or \"cpu\" (gloo)")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs the default process group: call "
            "torch.distributed.init_process_group(rank=..., world_size=..., "
            "...) on every rank first")
    if rows * cols != dist.get_world_size():
        raise ValueError(f"a {rows} x {cols} mesh needs {rows * cols} ranks, "
                         f"the world has {dist.get_world_size()}")
    backend = _BACKENDS[dev.type]
    opts = (dist.ProcessGroupNCCL.Options() if backend == "nccl"
            else dist.ProcessGroupGloo._Options())
    opts._timeout = datetime.timedelta(seconds=timeout)
    return init_device_mesh(dev.type, (rows, cols), mesh_dim_names=(row, col),
                            backend_override={row: (backend, opts),
                                              col: (backend, opts)})


class _Axes(NamedTuple):
    nrow: int
    ncol: int
    row: dist.ProcessGroup
    col: dist.ProcessGroup


def _axes(mesh, row: str, col: str) -> _Axes:
    size = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return _Axes(size[row], size[col], mesh.get_group(row),
                 mesh.get_group(col))


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# --------------------------------------------------------------------------
# collectives and shuffle primitives
# --------------------------------------------------------------------------

def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """``all_gather`` along one axis → ``[axis size, *x.shape]``, in the
    axis's order."""
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.numel(),))
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1), group=group)
    return out.reshape(n, *x.shape)


def _pack(cols: Mapping[str, torch.Tensor], valid: torch.Tensor):
    """Columns and validity stacked into one int32 tensor before the last
    dim (``[k + 1, n]`` rows, ``[n_dest, k + 1, cap]`` send buffers), so
    that one collective carries them all."""
    return torch.stack([*cols.values(), valid.to(torch.int32)], -2)


def _unpack(names, packed: torch.Tensor) -> Relation:
    """Inverse of ``_pack`` after a collective that put the sources along
    dim 0: each column flattened source-major."""
    cols = {k: packed[:, i].reshape(-1) for i, k in enumerate(names)}
    return Relation(cols, packed[:, -1].reshape(-1) != 0)


def _to_buckets(rel: Relation, dest: torch.Tensor, n_dest: int,
                cap: int) -> partition.Buckets:
    """Pack local rows into [n_dest, cap] send buffers (+ overflow flag)."""
    ids = torch.where(rel.valid, dest, torch.full_like(dest, n_dest))
    return partition.bucketize_by_ids(rel, ids, n_dest, cap, (n_dest,))


def _all_to_all(cols: Mapping[str, torch.Tensor], valid: torch.Tensor,
                group) -> Relation:
    """Exchange [n_dest, cap] buffers along a mesh axis → received rows,
    flattened back to a local [n_src * cap] relation.  Equal splits arrive
    source-major, as ``lax.all_to_all(..., tiled=True)`` concatenates
    them; the columns travel packed in one ``all_to_all_single``."""
    send = _pack(cols, valid).contiguous()          # [n_dest, k + 1, cap]
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return _unpack(list(cols), recv)


def _shuffle(rel: Relation, key_col: str, group, n_dest: int, cap: int,
             fn: str) -> tuple[Relation, torch.Tensor]:
    """Route rows to the rank at position hash(key) along an axis."""
    dest = hashing.hash_bucket(rel.col(key_col), n_dest, fn)
    b = _to_buckets(rel, dest, n_dest, cap)
    return _all_to_all(b.columns, b.valid, group), b.overflowed


def _replicate(rel: Relation, group) -> Relation:
    """``all_gather`` along an axis (the paper's broadcast) → the axis's
    stripes concatenated in its order."""
    return _unpack(list(rel.columns),
                   _gather(_pack(rel.columns, rel.valid), group))


def _or_all(x: torch.Tensor, axes) -> torch.Tensor:
    """Global bitwise OR via all_gather + local reduce (for FM bitmaps)."""
    for group in axes:
        x = functools.reduce(torch.bitwise_or, _gather(x, group).unbind(0))
    return x


def _psum(x: torch.Tensor, axes) -> torch.Tensor:
    """Sum over the given axes (``all_reduce``, in place, returned)."""
    for group in axes:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _psum_bool(x: torch.Tensor, axes) -> torch.Tensor:
    return _psum(x.to(torch.int32), axes) > 0


def _scaled(cap: int, scale: float, align: int = 8) -> int:
    if scale == 1.0:
        return cap
    return max(align, int(math.ceil(cap * scale / align)) * align)


# --------------------------------------------------------------------------
# per-kind local cores: shuffles + local fused/scan join on one rank.
# Each returns (local count, local join overflow, shuffle overflow) so both
# the one-shot wrappers and the recovery rounds can share them.  ``row``
# and ``col`` are the axes' process groups.
# --------------------------------------------------------------------------

def _cyclic_local_core(nrow, ncol, row, col, *, shuffle_slack=3.0,
                       local_uh=4, local_ug=4, local_f=2, local_slack=3.0,
                       fused=False, salt=0, cap_scale=1.0, shuffle_caps=None,
                       local_caps=None, pair_index=True):
    """R(a,b), S(b,c), T(c,a) arrive striped in arrival order; rank (i, j)
    ends up owning R tuples with (H(a), G(b)) == (i, j), the full S_j column
    partition and the full T_i row partition — exactly Fig 3."""
    sc = shuffle_caps or {}

    def local(r: Relation, s: Relation, t: Relation):
        # --- R → cell (H(a), G(b)): two-phase all_to_all ----------------
        cap_r = sc.get("r1") or partition.suggest_capacity(
            r.capacity, nrow, shuffle_slack)
        r1, ovf_r1 = _shuffle(r, "a", row, nrow, cap_r, "H")
        cap_r2 = sc.get("r2") or partition.suggest_capacity(
            r1.capacity, ncol, shuffle_slack)
        r2, ovf_r2 = _shuffle(r1, "b", col, ncol, cap_r2, "G")

        # --- S → column G(b), replicated down the column ----------------
        cap_s = sc.get("s1") or partition.suggest_capacity(
            s.capacity, ncol, shuffle_slack)
        s1, ovf_s = _shuffle(s, "b", col, ncol, cap_s, "G")
        s2 = _replicate(s1, row)

        # --- T → row H(a), replicated across the row --------------------
        cap_t = sc.get("t1") or partition.suggest_capacity(
            t.capacity, nrow, shuffle_slack)
        t1, ovf_t = _shuffle(t, "a", row, nrow, cap_t, "H")
        t2 = _replicate(t1, col)

        # --- local grid join --------------------------------------------
        caps = local_caps or (
            _scaled(partition.suggest_capacity(
                r2.capacity, local_uh * local_ug, local_slack), cap_scale),
            _scaled(partition.suggest_capacity(
                s2.capacity, local_f * local_ug, local_slack), cap_scale),
            _scaled(partition.suggest_capacity(
                t2.capacity, local_f * local_uh, local_slack), cap_scale))
        plan = cyclic3.Cyclic3Plan(
            h_parts=1, g_parts=1, uh=local_uh, ug=local_ug, f_parts=local_f,
            r_cap=caps[0], s_cap=caps[1], t_cap=caps[2])
        if fused:
            res = engine.cyclic3_count_fused(r2, s2, t2, plan, salt=salt,
                                             pair_index=pair_index)
        else:
            res = cyclic3.cyclic3_count(r2, s2, t2, plan)
        return res.count, res.overflowed, ovf_r1 | ovf_r2 | ovf_s | ovf_t

    return local


def _linear_local_core(nrow, ncol, row, col, *, shuffle_slack=3.0,
                       local_u=8, local_g=4, local_slack=3.0, fused=False,
                       salt=0, cap_scale=1.0, shuffle_caps=None,
                       local_caps=None):
    """Distributed Algorithm 1: the whole mesh is the flat U-way PMU grid.
    R and S shuffle to rank h(B) (two-phase: row then col hash of B);
    T is broadcast to every rank."""
    sc = shuffle_caps or {}

    def local(r: Relation, s: Relation, t: Relation):
        cap_r = sc.get("r1") or partition.suggest_capacity(
            r.capacity, nrow, shuffle_slack)
        r1, ovf_r1 = _shuffle(r, "b", row, nrow, cap_r, "H")
        cap_r2 = sc.get("r2") or partition.suggest_capacity(
            r1.capacity, ncol, shuffle_slack)
        r2, ovf_r2 = _shuffle(r1, "b", col, ncol, cap_r2, "G")

        cap_s = sc.get("s1") or partition.suggest_capacity(
            s.capacity, nrow, shuffle_slack)
        s1, ovf_s1 = _shuffle(s, "b", row, nrow, cap_s, "H")
        cap_s2 = sc.get("s2") or partition.suggest_capacity(
            s1.capacity, ncol, shuffle_slack)
        s2, ovf_s2 = _shuffle(s1, "b", col, ncol, cap_s2, "G")

        # T broadcast to all ranks (streamed bucket-by-bucket locally)
        t2 = _replicate(_replicate(t, row), col)

        caps = local_caps or (
            _scaled(partition.suggest_capacity(
                r2.capacity, local_u, local_slack), cap_scale),
            _scaled(partition.suggest_capacity(
                s2.capacity, local_g * local_u, local_slack), cap_scale),
            _scaled(partition.suggest_capacity(
                t2.capacity, local_g, local_slack), cap_scale))
        plan = linear3.Linear3Plan(h_parts=1, u=local_u, g_parts=local_g,
                                   r_cap=caps[0], s_cap=caps[1],
                                   t_cap=caps[2])
        if fused:
            res = engine.linear3_count_fused(r2, s2, t2, plan, salt=salt)
        else:
            res = linear3.linear3_count(r2, s2, t2, plan)
        return res.count, res.overflowed, ovf_r1 | ovf_r2 | ovf_s1 | ovf_s2

    return local


def _star_local_core(nrow, ncol, row, col, *, shuffle_slack=3.0,
                     local_chunks=1, local_slack=3.0, fused=False, salt=0,
                     cap_scale=1.0, shuffle_caps=None, local_caps=None,
                     local_uh=4, local_ug=4):
    """Distributed star join: R pinned by h(B) on rows (replicated along
    cols), T pinned by g(C) on cols (replicated along rows); each fact tuple
    s(b,c) is routed to exactly the one rank (h(b), g(c))."""
    sc = shuffle_caps or {}

    def local(r: Relation, s: Relation, t: Relation):
        # routing uses the coarse H/G families, NOT the local layout's
        # h/g: with a shared family (and salt 0 in round 0) rank-local
        # buckets would be modulo-correlated with rank placement,
        # leaving most local buckets empty and the loaded ones ~uh x over
        cap_r = sc.get("r1") or partition.suggest_capacity(
            r.capacity, nrow, shuffle_slack)
        r1, ovf_r = _shuffle(r, "b", row, nrow, cap_r, "H")
        r2 = _replicate(r1, col)

        cap_t = sc.get("t1") or partition.suggest_capacity(
            t.capacity, ncol, shuffle_slack)
        t1, ovf_t = _shuffle(t, "c", col, ncol, cap_t, "G")
        t2 = _replicate(t1, row)

        # fact: two-phase point routing (H(b) row, then G(c) col)
        cap_s = sc.get("s1") or partition.suggest_capacity(
            s.capacity, nrow, shuffle_slack)
        s1, ovf_s1 = _shuffle(s, "b", row, nrow, cap_s, "H")
        cap_s2 = sc.get("s2") or partition.suggest_capacity(
            s1.capacity, ncol, shuffle_slack)
        s2, ovf_s2 = _shuffle(s1, "c", col, ncol, cap_s2, "G")

        caps = local_caps or (
            _scaled(partition.suggest_capacity(
                r2.capacity, local_uh, local_slack), cap_scale),
            _scaled(partition.suggest_capacity(
                s2.capacity, local_chunks * local_uh * local_ug,
                local_slack), cap_scale),
            _scaled(partition.suggest_capacity(
                t2.capacity, local_ug, local_slack), cap_scale))
        plan = star3.Star3Plan(uh=local_uh, ug=local_ug, chunks=local_chunks,
                               r_cap=caps[0], s_cap=caps[1], t_cap=caps[2])
        if fused:
            res = engine.star3_count_fused(r2, s2, t2, plan, salt=salt)
        else:
            res = star3.star3_count(r2, s2, t2, plan)
        return res.count, res.overflowed, ovf_r | ovf_t | ovf_s1 | ovf_s2

    return local


_CORES = {"linear": _linear_local_core, "cyclic": _cyclic_local_core,
          "star": _star_local_core}


# --------------------------------------------------------------------------
# one-shot wrappers (count + a single overflow flag)
# --------------------------------------------------------------------------

def _count_sharded(ax: _Axes, local):
    def fn(r: Relation, s: Relation, t: Relation) -> DistJoinResult:
        count, loc_ovf, sh_ovf = local(r, s, t)
        tot = _psum(torch.stack([count.to(torch.int64),
                                 (loc_ovf | sh_ovf).to(torch.int64)]),
                    (ax.row, ax.col))
        return DistJoinResult(tot[0], tot[1] > 0)

    return fn


def cyclic3_count_sharded(mesh, row: str, col: str, **kw):
    """Build a distributed triangle count ``f(R, S, T) -> result`` (the
    paper's grid algorithm, §5.1, on the mesh); every rank calls it with
    its stripes."""
    ax = _axes(mesh, row, col)
    return _count_sharded(ax, _cyclic_local_core(*ax, **kw))


def linear3_count_sharded(mesh, row: str, col: str, **kw):
    """Distributed Algorithm 1 (§4); the |R||T|/M term of the cost model
    becomes the T all-gather bytes.  Call once per coarse H(B) partition
    when R exceeds aggregate device memory."""
    ax = _axes(mesh, row, col)
    return _count_sharded(ax, _linear_local_core(*ax, **kw))


def star3_count_sharded(mesh, row: str, col: str, **kw):
    """Distributed star join (§6.5): S crosses the network once, R and T are
    the only replicated (small) relations."""
    ax = _axes(mesh, row, col)
    return _count_sharded(ax, _star_local_core(*ax, **kw))


# --------------------------------------------------------------------------
# cross-device skew recovery (engine entry point)
# --------------------------------------------------------------------------

def _round_sharded(ax: _Axes, local):
    """One recovery round: the summed exact partials of overflow-free
    ranks (int64, so past 2^31 too), the per-rank overflow bitmap
    ``[nrow, ncol]`` (on the device) and the global shuffle-overflow flag.
    One gather along each axis carries all three; every rank reads the
    same values."""
    def fn(r: Relation, s: Relation, t: Relation):
        count, loc_ovf, sh_ovf = local(r, s, t)
        kept = torch.where(loc_ovf, torch.zeros_like(count), count)
        mine = torch.stack([kept.to(torch.int64), loc_ovf.to(torch.int64),
                            sh_ovf.to(torch.int64)])
        g = _gather(_gather(mine, ax.col), ax.row)      # [nrow, ncol, 3]
        host = g.cpu()
        return (int(host[..., 0].sum()), g[..., 1] != 0,
                bool(host[..., 2].any()))

    return fn


def _device_of(kind: str, rel_key: str, rel: Relation, nrow: int,
               ncol: int) -> tuple:
    """Mesh position (i, j) per row — the pure-function image of the
    (unsalted) shuffle destinations, on the device.  Used for residual
    masks and exact final-round capacity histograms; never moves data."""
    def bucket(c, nb, fn):
        return hashing.hash_bucket(rel.col(c), nb, fn).to(torch.int64)

    if kind == "linear":                      # r/s by H,G of b; t replicated
        return bucket("b", nrow, "H"), bucket("b", ncol, "G")
    if kind == "cyclic":
        if rel_key == "r":
            return bucket("a", nrow, "H"), bucket("b", ncol, "G")
        if rel_key == "s":                    # column-replicated
            return None, bucket("b", ncol, "G")
        return bucket("a", nrow, "H"), None
    # star
    if rel_key == "r":                        # row-pinned, col-replicated
        return bucket("b", nrow, "H"), None
    if rel_key == "t":
        return None, bucket("c", ncol, "G")
    return bucket("b", nrow, "H"), bucket("c", ncol, "G")


_DRIVING = {"linear": ("r", "s"), "cyclic": ("r",), "star": ("s",)}


def _mask_residual(kind: str, rels: dict, bad: torch.Tensor, nrow: int,
                   ncol: int) -> dict:
    """Keep only the driving relation's rows that live on overflowed
    ranks; their rank is a hash of their keys, so no shuffle is needed and
    each rank masks its own stripe, on the device."""
    out = dict(rels)
    for key in _DRIVING[kind]:
        i, j = _device_of(kind, key, rels[key], nrow, ncol)
        keep = bad[0 if i is None else i, 0 if j is None else j]
        out[key] = rels[key].mask_where(keep)
    return out


def _acceptall_shuffle_caps(kind: str, rels: dict, nrow: int,
                            ncol: int) -> dict:
    """Send-buffer capacities that can absorb ANY routing (every destination
    bucket can hold the whole local stripe) — shuffle overflow impossible."""
    lr, ls, lt = (rels[k].capacity for k in ("r", "s", "t"))
    if kind == "linear":
        return {"r1": lr, "r2": nrow * lr, "s1": ls, "s2": nrow * ls}
    if kind == "cyclic":
        return {"r1": lr, "r2": nrow * lr, "s1": ls, "t1": lt}
    return {"r1": lr, "t1": lt, "s1": ls, "s2": nrow * ls}


def _exact_local_caps(kind: str, rels: dict, salt: int, ax: _Axes,
                      dims: dict) -> tuple[int, int, int]:
    """Exact per-bucket capacities for the final round: the (rank, local
    bucket) of a row is a pure function of its keys, so the true maximum
    bucket load is one histogram per relation — each rank bincounts its
    own rows on the device and the histograms are summed over the mesh."""
    nrow, ncol = ax.nrow, ax.ncol

    def h(rel, c, nb, fn):
        return hashing.hash_bucket(rel.col(c), nb, fn, salt).to(torch.int64)

    r, s, t = rels["r"], rels["s"], rels["t"]
    if kind == "linear":
        u, g = dims["local_u"], dims["local_g"]
        ri, rj = _device_of(kind, "r", r, nrow, ncol)
        r_flat = (ri * ncol + rj) * u + h(r, "b", u, "h")
        si, sj = _device_of(kind, "s", s, nrow, ncol)
        s_flat = ((si * ncol + sj) * g + h(s, "c", g, "g")) * u \
            + h(s, "b", u, "h")
        t_flat = h(t, "c", g, "g")                         # replicated
        flats = ((r_flat, nrow * ncol * u), (s_flat, nrow * ncol * g * u),
                 (t_flat, g))
    elif kind == "cyclic":
        uh, ug, fp = dims["local_uh"], dims["local_ug"], dims["local_f"]
        ri, rj = _device_of(kind, "r", r, nrow, ncol)
        r_flat = ((ri * ncol + rj) * uh + h(r, "a", uh, "h")) * ug \
            + h(r, "b", ug, "g")
        _, sj = _device_of(kind, "s", s, nrow, ncol)
        s_flat = (sj * fp + h(s, "c", fp, "f")) * ug + h(s, "b", ug, "g")
        ti, _ = _device_of(kind, "t", t, nrow, ncol)
        t_flat = (ti * fp + h(t, "c", fp, "f")) * uh + h(t, "a", uh, "h")
        flats = ((r_flat, nrow * ncol * uh * ug), (s_flat, ncol * fp * ug),
                 (t_flat, nrow * fp * uh))
    else:
        # star (chunks forced to 1 in the final round: arrival-order chunk
        # ids are layout-dependent, the hashed (h, g) cell is not)
        uh, ug = dims["local_uh"], dims["local_ug"]
        ri, _ = _device_of(kind, "r", r, nrow, ncol)
        r_flat = ri * uh + h(r, "b", uh, "h")
        _, tj = _device_of(kind, "t", t, nrow, ncol)
        t_flat = tj * ug + h(t, "c", ug, "g")
        si, sj = _device_of(kind, "s", s, nrow, ncol)
        s_flat = ((si * ncol + sj) * uh + h(s, "b", uh, "h")) * ug \
            + h(s, "c", ug, "g")
        flats = ((r_flat, nrow * uh), (s_flat, nrow * ncol * uh * ug),
                 (t_flat, ncol * ug))
    sizes = [n for _, n in flats]
    hist = torch.cat([torch.bincount(flat[rel.valid], minlength=n)
                      for (flat, n), rel in zip(flats, (r, s, t))])
    hist = _psum(hist, (ax.row, ax.col)).cpu().numpy()
    return tuple(exact_cap(part)
                 for part in np.split(hist, np.cumsum(sizes)[:-1]))


def engine_count_sharded(mesh, row: str, col: str, kind: str = "linear", *,
                         max_rounds: int = 2, growth: float = 2.0,
                         shuffle_slack: float = 3.0, **kw):
    """Distributed fused-engine join WITH cross-device skew recovery.

    Returns ``fn(r, s, t) -> DistEngineResult``, which every rank calls
    with its stripes.  Per round: every rank joins its share with a salted
    local plan, the exact partials of overflow-free ranks are summed, and
    the per-rank overflow bitmap is gathered; only the rows owned by
    overflowed ranks re-run.  The final round is exact-sized (accept-all
    shuffles + histogram-true bucket capacities), so ``overflowed`` is
    always False and the count is exact under ANY skew.
    """
    if kind not in _CORES:
        raise ValueError(f"unknown kind {kind!r}; choose from "
                         f"{sorted(_CORES)}")
    ax = _axes(mesh, row, col)
    core = _CORES[kind]
    dims = {"linear": {"local_u": 8, "local_g": 4},
            "cyclic": {"local_uh": 4, "local_ug": 4, "local_f": 2},
            "star": {"local_uh": 4, "local_ug": 4}}[kind]
    dims.update({k: v for k, v in kw.items() if k in dims})

    def fn(r: Relation, s: Relation, t: Relation) -> DistEngineResult:
        rels = {"r": r, "s": s, "t": t}
        total, rounds = 0, 0
        sh_scale, cap_scale = 1.0, 1.0
        for rnd in range(max_rounds + 1):
            final = rnd == max_rounds
            opts = dict(kw)
            if final:
                opts["shuffle_caps"] = _acceptall_shuffle_caps(
                    kind, rels, ax.nrow, ax.ncol)
                opts["local_caps"] = _exact_local_caps(kind, rels, rnd, ax,
                                                       dims)
                if kind == "star":
                    opts["local_chunks"] = 1
            local = core(*ax, fused=True, salt=rnd, cap_scale=cap_scale,
                         shuffle_slack=shuffle_slack * sh_scale, **opts)
            kept, bad, sh_any = _round_sharded(ax, local)(
                rels["r"], rels["s"], rels["t"])
            rounds += 1
            if sh_any:
                # send buffers dropped rows: the round's partials are not
                # trustworthy anywhere — discard and retry with roomier
                # shuffles (the final round's accept-all caps cannot hit
                # this branch)
                assert not final, "accept-all shuffle caps overflowed"
                sh_scale *= growth
                cap_scale *= growth
                continue
            total += kept
            if not bool(bad.any()):
                return DistEngineResult(np.int64(total), False, rounds)
            assert not final, "exact-sized final round overflowed"
            rels = _mask_residual(kind, rels, bad, ax.nrow, ax.ncol)
            cap_scale *= growth
        raise AssertionError("unreachable: final round is exact-sized")

    return fn


# --------------------------------------------------------------------------
# helpers for drivers/tests
# --------------------------------------------------------------------------

def global_cardinalities(mesh, row: str, col: str,
                         rels: Mapping[str, Relation]) -> dict[str, int]:
    """Live rows of each relation over the whole mesh (int64 sums; every
    rank gets the same numbers)."""
    ax = _axes(mesh, row, col)
    n = torch.stack([rel.n.to(torch.int64) for rel in rels.values()])
    return dict(zip(rels, _psum(n, (ax.row, ax.col)).tolist()))


def shard_relation(rel: Relation, mesh, row: str, col: str) -> Relation:
    """This rank's stripe of a relation every rank holds whole: rows
    [k·L, (k+1)·L) for the rank at mesh position (i, j), k = i·ncol + j
    and L = capacity / (nrow·ncol), on this rank's device
    (``pad_to_multiple`` first)."""
    ax = _axes(mesh, row, col)
    ndev = ax.nrow * ax.ncol
    if rel.capacity % ndev:
        raise ValueError(f"capacity {rel.capacity} does not divide over "
                         f"{ndev} ranks; pad_to_multiple first")
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    k = coord[row] * ax.ncol + coord[col]
    stripe = slice(k * (rel.capacity // ndev), (k + 1) * (rel.capacity // ndev))
    dev = _mesh_device(mesh)
    return Relation({c: v[stripe].to(dev) for c, v in rel.columns.items()},
                    rel.valid[stripe].to(dev))


def pad_to_multiple(rel: Relation, multiple: int) -> Relation:
    """Pad capacity so it divides evenly over the mesh."""
    rem = (-rel.capacity) % multiple
    if rem == 0:
        return rel
    pad = torch.nn.functional.pad
    return Relation({k: pad(v, (0, rem)) for k, v in rel.columns.items()},
                    pad(rel.valid, (0, rem)))
