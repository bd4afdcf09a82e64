"""The kernel ops of the join engine, and their plain versions.

Three families:

  * the fused partition-sweep ops (``fused_*``) of the engine's hot path:
    one call covers a whole coarse partition sweep;
  * the bucket-row ops (``bucket_*``) of the scan-driver baselines
    (``core.linear3``, ``core.star3``, ``core.cyclic3``,
    ``core.binary_join.bucketed_join_count``): per bucket row, one count
    (or one count per R slot).  Their operands are ``[*batch, C]`` bucket
    rows whose batch shapes broadcast against each other as torch shapes
    do: a size-1 batch dimension shares one bucket row across that
    dimension without copying it (the T bucket that Algorithm 1 broadcasts
    to every PMU, the S and T rows the cyclic grid broadcasts down columns
    and across rows).  ``[B, C]`` operands are the reference's contract;
  * ``radix_histogram``: the per-bucket counts of a hashed key stream.

Each public op dispatches on the device of its tensors, and its plain
version masks invalid slots with per-side sentinels (so an invalid slot
can never equal anything on another side).  Every join kernel reads the
validity masks itself, so no op masks or sorts before it launches: each
passes the raw keys and validity (``fused_count3_linear``,
``fused_per_r_counts``, ``fused_count3_star``, ``fused_count3_cyclic`` in
both forms, ``bucket_pair_count``, ``bucket_count3_linear``,
``bucket_per_r_counts`` and ``bucket_count3_cyclic``):

  * a CUDA tensor launches the hand-written Hopper kernel
    (``kernels.cuda``); a kernel that fails to build or launch raises —
    there is no fallback,
  * a CPU tensor takes the plain PyTorch version beside it in this module
    (``_fused_linear_ref``, ``_bucket_linear_ref`` and their siblings).

``bucket_count3_cyclic_pairidx`` is plain torch on every device, as the
reference computes it outside any Pallas kernel.

The reference padded every capacity to 128 lanes for the TPU; the CUDA
kernels take any capacity, so nothing is padded here (padding with
sentinels could not change a count anyway).

Keys must be > SENT_BASE (= -2^31 + 16); the data layer guarantees int32
keys ≥ -2^30.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.relation import SENTINEL

# Per-side probe sentinels, derived from the ONE canonical padding sentinel
# (``relation.SENTINEL``, also the fill value of every bucketized layout) so
# the whole constellation lives in [SENTINEL, SENTINEL + 20] — far below the
# ≥ -2^30 key floor — and no two sides can ever false-match each other or a
# padded slot.
SENT_BASE = SENTINEL + 15
_SENT = {"r": SENT_BASE + 1, "s": SENT_BASE + 2, "t": SENT_BASE + 3,
         "a": SENT_BASE + 4, "b": SENT_BASE + 5}
assert len(set(_SENT.values()) | {SENTINEL}) == len(_SENT) + 1

# Largest integer f32 represents exactly (24-bit mantissa).  The fused
# kernels accumulate per-cell partials in int32 on purpose;
# ``analysis.widths`` flags accumulator cells whose capacity-product
# ceiling crosses it.
EXACT_F32_MAX = 1 << 24

_INT32_MIN = -(2**31)

# Largest number of (s, r) pairs a chunk of the plain cyclic version
# expands at once; bounds its memory at any shape and skew.
_PLAIN_CHUNK_ELEMS = 1 << 24


def _mask(keys: torch.Tensor, valid: torch.Tensor, side: str) -> torch.Tensor:
    return torch.where(valid, keys, torch.full_like(keys, _SENT[side]))


def _on_cuda(x: torch.Tensor, op: str) -> bool:
    """Dispatch rule: CUDA tensors take the kernel, CPU tensors the plain
    version; any other device is refused."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{op}: unsupported device {x.device}")


def _sum_int32(x: torch.Tensor, dims) -> torch.Tensor:
    """Sum with int32 wrap-around, like the reference's int32 reductions
    (torch sums int32 into int64; the cast back keeps the low 32 bits)."""
    return torch.sum(x.to(torch.int64), dim=dims).to(torch.int32)


def batch_shape(*rows: torch.Tensor) -> tuple:
    """The broadcast batch shape of bucket-row operands ``[*batch, C]``."""
    return tuple(torch.broadcast_shapes(*(x.shape[:-1] for x in rows)))


def _flat_rows(x: torch.Tensor, batch: tuple) -> torch.Tensor:
    """``x [*b, C]`` broadcast to ``batch`` as ``[prod(batch), C]`` (copies
    shared rows)."""
    return x.expand(*batch, x.shape[-1]).reshape(-1, x.shape[-1])


def _row_index(x: torch.Tensor, batch: tuple) -> torch.Tensor:
    """For each bucket of ``batch`` (flattened), the index of its row among
    the rows of ``x [*b, C]`` (a shared row serves many buckets)."""
    n = x.shape[:-1].numel()
    idx = torch.arange(n, device=x.device).reshape(x.shape[:-1])
    return idx.expand(batch).reshape(-1)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _multiplicity(table, probes, batch: tuple) -> torch.Tensor:
    """Per probe, how many equal keys its own bucket row of ``table``
    holds: table [*b, Ct] (rows may be shared along size-1 batch
    dimensions: sorted once, never copied), probes [*batch, Cp] ->
    [prod(batch), Cp] int32.  One sort of the (row, key) pairs and two
    binary searches per probe."""
    ct = table.shape[-1]
    t_row = torch.arange(table.numel(), device=table.device) // ct
    srt = torch.sort(pair_keys(t_row, table.reshape(-1))).values
    q = pair_keys(_row_index(table, batch)[:, None],
                  _flat_rows(probes, batch))
    return (torch.searchsorted(srt, q, side="right")
            - torch.searchsorted(srt, q, side="left")).to(torch.int32)


def _fused_linear_ref(rb, sb, sc, tc):
    """rb [hp,u,Cr], sb/sc [hp,gp,u,Cs], tc [gp,Ct] -> [hp,u] int32.

    Every S slot is weighted by its R multiplicity (probing the matching
    (H, h) bucket) times its T multiplicity (probing the matching g
    bucket), then summed per (H, h).
    """
    hp, u, cr = rb.shape
    _, gp, _, cs = sb.shape
    s_by_r = sb.permute(0, 2, 1, 3).reshape(hp * u, gp * cs)
    wr = _multiplicity(rb.reshape(hp * u, cr), s_by_r, (hp * u,))
    s_by_t = sc.permute(1, 0, 2, 3).reshape(gp, hp * u * cs)
    wt = _multiplicity(tc, s_by_t, (gp,))
    wt = wt.reshape(gp, hp, u, cs).permute(1, 2, 0, 3).reshape(
        hp * u, gp * cs)
    return _sum_int32(wr * wt, -1).reshape(hp, u)


def _fused_per_r_ref(rb, sb, sc, tc):
    """rb [hp,u,Cr], sb/sc [hp,gp,u,Cs], tc [gp,Ct] -> [hp,u,Cr] int32.

    Per R slot: the sum, over the S slots of its (H, h) bucket with an
    equal b, of that S slot's T multiplicity.  Realized with sorted S
    keys, a prefix sum of their weights and two binary searches per R
    slot.
    """
    hp, u, cr = rb.shape
    _, gp, _, cs = sb.shape
    s_by_t = sc.permute(1, 0, 2, 3).reshape(gp, hp * u * cs)
    wt = _multiplicity(tc, s_by_t, (gp,)).reshape(gp, hp, u, cs)
    wt = wt.permute(1, 2, 0, 3).reshape(hp * u, gp * cs)
    keys = sb.permute(0, 2, 1, 3).reshape(hp * u, gp * cs)
    return _per_r_sums(keys, wt, rb.reshape(hp * u, cr)).reshape(hp, u, cr)


def _per_r_sums(keys: torch.Tensor, wt: torch.Tensor,
                probes: torch.Tensor) -> torch.Tensor:
    """Per probe (R slot) of row i: the sum of ``wt`` over the slots of
    ``keys`` row i that equal it.  keys/wt [B, Cs], probes [B, Cr] ->
    [B, Cr] int32 (sorted keys, a prefix sum of their weights and two
    binary searches per probe)."""
    skeys, order = torch.sort(keys, dim=-1, stable=True)
    cw = torch.nn.functional.pad(torch.cumsum(
        torch.gather(wt.to(torch.int64), 1, order), dim=1), (1, 0))
    probes = probes.contiguous()
    lo = torch.searchsorted(skeys, probes, side="left")
    hi = torch.searchsorted(skeys, probes, side="right")
    out = torch.gather(cw, 1, hi) - torch.gather(cw, 1, lo)
    return out.to(torch.int32)


def _bucket_pair_ref(ka, kb):
    """ka [*batch, Ca], kb [*batch, Cb] -> [*batch] int32: per bucket row,
    the number of equal (a, b) key pairs."""
    batch = batch_shape(ka, kb)
    return _sum_int32(_multiplicity(kb, ka, batch), -1).reshape(batch)


def _bucket_linear_ref(rb, sb, sc, tc):
    """rb [*batch, Cr], sb/sc [*batch, Cs], tc [*batch, Ct] -> [*batch]
    int32: per bucket row, Σ_s #{r : r.b = s.b} · #{t : t.c = s.c}."""
    batch = batch_shape(rb, sb, sc, tc)
    wr = _multiplicity(rb, sb, batch)
    wt = _multiplicity(tc, sc, batch)
    return _sum_int32(wr * wt, -1).reshape(batch)


def _bucket_per_r_ref(rb, sb, sc, tc):
    """Same operands as ``_bucket_linear_ref`` -> [*batch, Cr] int32: per R
    slot, Σ over the S slots of its bucket row with s.b = r.b of
    #{t : t.c = s.c}."""
    batch = batch_shape(rb, sb, sc, tc)
    wt = _multiplicity(tc, sc, batch)
    out = _per_r_sums(_flat_rows(sb, batch), wt, _flat_rows(rb, batch))
    return out.reshape(*batch, rb.shape[-1])


def pair_keys(tc: torch.Tensor, ta: torch.Tensor) -> torch.Tensor:
    """One int64 key per (c, a) pair whose order is the lexicographic
    (c, then a) order: ``(c << 32) + (a - INT32_MIN)``."""
    return tc.to(torch.int64) * (1 << 32) + (ta.to(torch.int64) - _INT32_MIN)


def sorted_pair_keys(tc: torch.Tensor, ta: torch.Tensor) -> torch.Tensor:
    """Each bucket row's (c, a) pair keys, sorted — the pair index the
    cyclic probes binary-search."""
    return torch.sort(pair_keys(tc, ta), dim=-1).values


def lex_sort_pairs(tc, ta):
    """Sort each bucket row's (c, a) pairs lexicographically by (c, then a).

    tc/ta: [..., Ct] sentinel-masked keys.  Returns (tc_sorted, ta_sorted).
    """
    key = sorted_pair_keys(tc, ta)
    return ((key >> 32).to(torch.int32),
            ((key & 0xFFFFFFFF) + _INT32_MIN).to(torch.int32))


def sorted_pair_index(tc, ta, tv):
    """Build the sorted (c, a)-pair index for a grid of T bucket rows:
    sentinel-mask invalid slots, then lex-sort each row by (c, then a)."""
    return lex_sort_pairs(_mask(tc, tv, "t"), _mask(ta, tv, "t"))


def _row_bisect(flat: torch.Tensor, base: torch.Tensor, n: int,
                q: torch.Tensor, right: bool) -> torch.Tensor:
    """Vectorized binary search of each ``q`` in its own sorted run
    ``flat[base : base + n]``: the first index whose key is > q (``right``)
    or >= q (not ``right``), as an absolute index into ``flat``."""
    lo, hi = base.clone(), base + n
    for _ in range(max(1, int(n).bit_length())):
        active = lo < hi
        mid = (lo + hi) // 2
        v = flat[torch.clamp(mid, max=flat.shape[0] - 1)]
        go = (v <= q) if right else (v < q)
        lo = torch.where(active & go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    return lo


def _cyclic_sort_join(ra, rb, r_srow, r_trow, r_cell, sb, sc, tkey,
                      n_cells: int) -> torch.Tensor:
    """The plain triangle count as a sort join.

    ra/rb [n_r]: R slots; r_srow/r_trow/r_cell [n_r] int64: the S row, T
    row and output cell of each R slot; sb/sc [n_srows, Cs]: S rows;
    tkey [n_trows, Ct]: sorted (c, a) pair keys of the T rows.  Returns
    [n_cells] int64: per cell, Σ over its R slots r and the S slots s of
    r's S row with s.b = r.b of #{t in r's T row : (t.c, t.a) = (s.c, r.a)}.

    The S slots are sorted by (row, b); every R slot finds its equal-b S
    slots with two binary searches; the matching (s, r) pairs are
    expanded in chunks that bound memory, and each pair's T count is the
    distance between two binary searches of its T row.
    """
    dev = ra.device
    cs, ct = sb.shape[-1], tkey.shape[-1]
    acc = torch.zeros(n_cells, dtype=torch.int64, device=dev)
    if ra.numel() == 0 or cs == 0 or ct == 0:
        return acc
    s_row = torch.arange(sb.numel(), device=dev) // cs
    s_sorted, s_order = torch.sort(pair_keys(s_row, sb.reshape(-1)))
    sc_flat = sc.reshape(-1)
    tflat = tkey.reshape(-1)
    r_key = pair_keys(r_srow, rb)
    lo = torch.searchsorted(s_sorted, r_key, side="left")
    n = torch.searchsorted(s_sorted, r_key, side="right") - lo
    ends = torch.cumsum(n, 0)
    r0 = 0
    while r0 < n.shape[0]:
        done = int(ends[r0 - 1]) if r0 else 0
        r1 = int(torch.searchsorted(ends, done + _PLAIN_CHUNK_ELEMS,
                                    side="right"))
        r1 = min(max(r1, r0 + 1), n.shape[0])
        n_c = n[r0:r1]
        r_idx = torch.repeat_interleave(torch.arange(r0, r1, device=dev), n_c)
        first = torch.repeat_interleave(torch.cumsum(n_c, 0) - n_c, n_c)
        rank = torch.arange(r_idx.shape[0], device=dev) - first
        s_idx = s_order[lo[r_idx] + rank]
        q = pair_keys(sc_flat[s_idx], ra[r_idx])
        base = r_trow[r_idx] * ct
        cnt = (_row_bisect(tflat, base, ct, q, right=True)
               - _row_bisect(tflat, base, ct, q, right=False))
        acc.index_add_(0, r_cell[r_idx], cnt)
        r0 = r1
    return acc


def _fused_cyclic_pairidx_ref(ra, rb, sb, sc, tc, ta):
    """ra/rb [hp,gp,uh,ug,Cr], sb/sc [gp,fp,ug,Cs], tc/ta [hp,fp,uh,Ct]
    -> [hp,gp,uh,ug] int32.

    Per cell (i, j, a, b) and stream bucket f: Σ over (s, r) of
    [s.b = r.b] · #{t : (t.c, t.a) = (s.c, r.a)}, with S bucket (j, f, b)
    and T bucket (i, f, a) (``_cyclic_sort_join``, once per f).  The
    plain version of both fused cyclic forms: the pair-index sweep and the
    all-pairs contraction compute the same per-cell counts.
    """
    hp, gp, uh, ug, cr = ra.shape
    _, fp, _, cs = sb.shape
    ct = tc.shape[-1]
    tkey = sorted_pair_keys(tc, ta).reshape(hp * fp * uh, ct)  # rows (i, f, a)
    n_cells = hp * gp * uh * ug
    cell = torch.arange(n_cells * cr, device=ra.device) // cr  # per R slot
    r_i = cell // (gp * uh * ug)
    r_a = (cell // ug) % uh
    r_col = ((cell // (uh * ug)) % gp) * ug + cell % ug  # S row (j, b)
    acc = torch.zeros(n_cells, dtype=torch.int64, device=ra.device)
    for f in range(fp):
        acc += _cyclic_sort_join(
            ra.reshape(-1), rb.reshape(-1), r_col, (r_i * fp + f) * uh + r_a,
            cell, sb[:, f].reshape(gp * ug, cs), sc[:, f].reshape(gp * ug, cs),
            tkey, n_cells)
    return acc.to(torch.int32).reshape(hp, gp, uh, ug)


def _bucket_cyclic_join(ra, rb, sb, sc, tkey) -> torch.Tensor:
    """ra/rb [*b, Cr], sb/sc [*b, Cs], tkey [*b, Ct] sorted (c, a) pair keys
    (batch shapes broadcast; shared rows are indexed, not copied) ->
    [*batch] int32 per-bucket triangle counts."""
    batch = batch_shape(ra, sb, tkey)
    n = math.prod(batch)
    cr = ra.shape[-1]
    dev = ra.device
    slot = (_row_index(ra, batch)[:, None] * cr
            + torch.arange(cr, device=dev)).reshape(-1)
    s_row, t_row, cell = (x.repeat_interleave(cr) for x in (
        _row_index(sb, batch), _row_index(tkey, batch),
        torch.arange(n, device=dev)))
    acc = _cyclic_sort_join(
        ra.reshape(-1)[slot], rb.reshape(-1)[slot], s_row, t_row, cell,
        sb.reshape(-1, sb.shape[-1]), sc.reshape(-1, sc.shape[-1]),
        tkey.reshape(-1, tkey.shape[-1]), n)
    return acc.to(torch.int32).reshape(batch)


def _bucket_cyclic_ref(ra, rb, sb, sc, tc, ta):
    """ra/rb [*batch, Cr], sb/sc [*batch, Cs], tc/ta [*batch, Ct] ->
    [*batch] int32: per bucket row, Σ_{r,s,t} [r.b=s.b][s.c=t.c][t.a=r.a]
    (the all-pairs contraction Σ (M1ᵀ·M2) ⊙ M3, computed as a sort
    join)."""
    return _bucket_cyclic_join(ra, rb, sb, sc, sorted_pair_keys(tc, ta))


def _fused_star_ref(rb, sb, sc, tc):
    """rb [uh,Cr], sb/sc [ch,uh,ug,Cs], tc [ug,Ct] -> [uh,ug] int32.

    Same sorted-bucket-probe scheme as ``_fused_linear_ref``: each fact slot
    probes the R bucket of its row and the T bucket of its column.
    """
    uh, cr = rb.shape
    ch, _, ug, cs = sb.shape
    s_by_r = sb.permute(1, 0, 2, 3).reshape(uh, ch * ug * cs)
    wr = _multiplicity(rb, s_by_r, (uh,))
    wr = wr.reshape(uh, ch, ug, cs).permute(1, 0, 2, 3)   # [ch,uh,ug,cs]
    s_by_t = sc.permute(2, 0, 1, 3).reshape(ug, ch * uh * cs)
    wt = _multiplicity(tc, s_by_t, (ug,))
    wt = wt.reshape(ug, ch, uh, cs).permute(1, 2, 0, 3)   # [ch,uh,ug,cs]
    return _sum_int32(wr * wt, (0, 3))


# --------------------------------------------------------------------------
# the ops: kernel (CUDA) or masked plain version (CPU)
# --------------------------------------------------------------------------

def _contiguous(*xs):
    return [x.contiguous() for x in xs]


def fused_count3_linear(rb, rv, sb, sc, sv, tc, tv):
    """Fused linear-3 sweep: per-(H, h) bucket counts [hp, u] int32.  The
    kernel reads the validity masks itself; the plain version masks."""
    if _on_cuda(rb, "fused_count3_linear"):
        from repro_torch.kernels import cuda
        return cuda.fused_count3_linear(*_contiguous(rb, rv, sb, sc, sv, tc,
                                                     tv))
    return _fused_linear_ref(_mask(rb, rv, "r"), _mask(sb, sv, "s"),
                             _mask(sc, sv, "s"), _mask(tc, tv, "t"))


def fused_per_r_counts(rb, rv, sb, sc, sv, tc, tv):
    """Fused per-R-slot counts [hp, u, Cr] int32 (Example 1 aggregate); 0
    for a dead R slot.  The kernel reads the validity masks itself; the
    plain version masks."""
    if _on_cuda(rb, "fused_per_r_counts"):
        from repro_torch.kernels import cuda
        return cuda.fused_per_r_counts(*_contiguous(rb, rv, sb, sc, sv, tc,
                                                    tv))
    return _fused_per_r_ref(_mask(rb, rv, "r"), _mask(sb, sv, "s"),
                            _mask(sc, sv, "s"), _mask(tc, tv, "t"))


def fused_count3_cyclic(ra, rb, rv, sb, sc, sv, tc, ta, tv, *,
                        pair_index: bool = True):
    """Fused cyclic sweep: per-cell counts [hp, gp, uh, ug] int32.

    ``pair_index=True`` (the session's path) is the reference's (c, a)-pair
    index of the T stream (``cuda.fused_count3_cyclic_pairidx``);
    ``pair_index=False`` the all-pairs contraction Σ (M1ᵀ·M2) ⊙ M3 of its
    MXU kernel (``cuda.fused_count3_cyclic``).  Both forms compute the same
    per-cell counts: on the card both kernels run the one sweep over
    shared-memory tables and read the validity masks themselves, each with
    its own launch counter; on the CPU both take the one plain version,
    which masks.
    """
    if _on_cuda(ra, "fused_count3_cyclic"):
        from repro_torch.kernels import cuda
        fn = (cuda.fused_count3_cyclic_pairidx if pair_index
              else cuda.fused_count3_cyclic)
        return fn(*_contiguous(ra, rb, rv, sb, sc, sv, tc, ta, tv))
    return _fused_cyclic_pairidx_ref(
        _mask(ra, rv, "r"), _mask(rb, rv, "r"), _mask(sb, sv, "s"),
        _mask(sc, sv, "s"), _mask(tc, tv, "t"), _mask(ta, tv, "t"))


def fused_count3_star(rb, rv, sb, sc, sv, tc, tv):
    """Fused star sweep: per-PMU counts [uh, ug] int32, summed over the
    fact table's chunks.  The kernel reads the validity masks itself; the
    plain version masks."""
    if _on_cuda(rb, "fused_count3_star"):
        from repro_torch.kernels import cuda
        return cuda.fused_count3_star(*_contiguous(rb, rv, sb, sc, sv, tc,
                                                   tv))
    return _fused_star_ref(_mask(rb, rv, "r"), _mask(sb, sv, "s"),
                           _mask(sc, sv, "s"), _mask(tc, tv, "t"))


# --------------------------------------------------------------------------
# bucket-row ops of the scan-driver baselines (operands [*batch, C],
# broadcast over size-1 batch dimensions)
# --------------------------------------------------------------------------

def bucket_pair_count(ka, va, kb, vb):
    """Per-bucket count of equal key pairs [*batch] int32 (the bucketed
    binary join).  Each validity has its keys' shape.  The kernel reads
    the validity masks itself; the plain version masks."""
    if _on_cuda(ka, "bucket_pair_count"):
        from repro_torch.kernels import cuda
        return cuda.bucket_pair_count(*_contiguous(ka, va, kb, vb))
    return _bucket_pair_ref(_mask(ka, va, "a"), _mask(kb, vb, "b"))


def bucket_count3_linear(rb, rv, sb, sc, sv, tc, tv):
    """Per-bucket linear 3-way counts [*batch] int32 (Algorithm 1's inner
    join).  Each validity has its keys' shape; on the card S spans the
    whole batch.  The kernel reads the validity masks itself; the plain
    version masks."""
    if _on_cuda(rb, "bucket_count3_linear"):
        from repro_torch.kernels import cuda
        return cuda.bucket_count3_linear(*_contiguous(rb, rv, sb, sc, sv, tc,
                                                      tv))
    return _bucket_linear_ref(_mask(rb, rv, "r"), _mask(sb, sv, "s"),
                              _mask(sc, sv, "s"), _mask(tc, tv, "t"))


def bucket_per_r_counts(rb, rv, sb, sc, sv, tc, tv):
    """Per-R-slot counts [*batch, Cr] int32 (Example 1's per-user
    aggregate), at the caller's Cr; 0 for a dead R slot.  Operands as
    ``bucket_count3_linear``'s."""
    if _on_cuda(rb, "bucket_per_r_counts"):
        from repro_torch.kernels import cuda
        return cuda.bucket_per_r_counts(*_contiguous(rb, rv, sb, sc, sv, tc,
                                                     tv))
    return _bucket_per_r_ref(_mask(rb, rv, "r"), _mask(sb, sv, "s"),
                             _mask(sc, sv, "s"), _mask(tc, tv, "t"))


def bucket_count3_cyclic(ra, rb, rv, sb, sc, sv, tc, ta, tv):
    """Per-bucket triangle counts [*batch] int32 (the all-pairs form).
    Each validity has its keys' shape.  The kernel reads the validity
    masks itself; the plain version masks."""
    if _on_cuda(ra, "bucket_count3_cyclic"):
        from repro_torch.kernels import cuda
        return cuda.bucket_count3_cyclic(*_contiguous(ra, rb, rv, sb, sc, sv,
                                                      tc, ta, tv))
    return _bucket_cyclic_ref(
        _mask(ra, rv, "r"), _mask(rb, rv, "r"), _mask(sb, sv, "s"),
        _mask(sc, sv, "s"), _mask(tc, tv, "t"), _mask(ta, tv, "t"))


def bucket_count3_cyclic_pairidx(ra, rb, rv, sb, sc, sv, tcs, tas):
    """Per-bucket triangle counts [*batch] int32 against a pre-built
    sorted pair index.

    Same contract as ``bucket_count3_cyclic`` except that the T side
    arrives as ``sorted_pair_index`` output (masked and lex-sorted, so no
    validity argument).  Plain torch on every device: the sort join of
    ``_cyclic_sort_join``, which never builds the reference's per-bucket
    Ct x Cr prefix table.
    """
    return _bucket_cyclic_join(_mask(ra, rv, "r"), _mask(rb, rv, "r"),
                               _mask(sb, sv, "s"), _mask(sc, sv, "s"),
                               pair_keys(tcs, tas))


# --------------------------------------------------------------------------
# radix histogram (the partitioning's per-bucket counts)
# --------------------------------------------------------------------------

def _radix_histogram_ref(keys, valid, n_buckets: int):
    """keys (n,) int32, valid (n,) bool -> (n_buckets,) int32: the plain
    version, ``hash_bucket(keys, n_buckets, "H")`` counted over live rows
    with ``torch.bincount``."""
    from repro_torch.core import hashing
    ids = hashing.hash_bucket(keys, n_buckets, "H")
    return torch.bincount(ids[valid].long(), minlength=n_buckets).to(
        torch.int32)


def radix_histogram(keys, valid, *, n_buckets: int):
    """Histogram of ``hash_bucket(keys, n_buckets, "H")`` over live rows,
    (n_buckets,) int32; exact at any count (int32 atomics on the card).
    On the card any contiguous view of the stream is read in place."""
    if keys.dim() != 1 or valid.shape != keys.shape:
        raise ValueError(f"radix_histogram: keys {tuple(keys.shape)} and "
                         f"valid {tuple(valid.shape)} must be one (n,) "
                         "stream")
    if _on_cuda(keys, "radix_histogram"):
        from repro_torch.kernels import cuda
        return cuda.radix_histogram(keys, valid, n_buckets=n_buckets)
    return _radix_histogram_ref(keys, valid, n_buckets)


# --------------------------------------------------------------------------
# FM sketch registers over the implicit 3-way join (Example 1's DISTINCT)
# --------------------------------------------------------------------------

# Largest number of index pairs a chunk of the FM join expands at once;
# bounds its memory at any shape and skew.
FM_CHUNK = 1 << 24

# The pair key's mixing seeds for a and d (``ref.fm_registers``).
_FM_SEED_A, _FM_SEED_D = 0x1B873593, 0xE6546B64


def fm_pair_keys(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The avalanche-mixed key of each (a, d) pair, int64 in [0, 2^32):
    the bits of the reference's int32 ``mix32(a) ^ mix32(d)``."""
    from repro_torch.core import hashing
    return hashing.mix32(a, _FM_SEED_A) ^ hashing.mix32(d, _FM_SEED_D)


def fm_fold(registers: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """``registers [B, K]`` int32 with every ``(bucket << 32) | pair`` key
    folded in: register k of a bucket ORs ``key_bits(pair, k)``."""
    from repro_torch.core import sketches
    n_buckets, n_registers = registers.shape
    base = (keys >> 32) * (32 * n_registers)
    words = registers.reshape(-1)
    for k in range(n_registers):
        slots = base + 32 * k + sketches.bit_index(keys & 0xFFFFFFFF, k)
        words = words | sketches.or_bits(slots, n_buckets * n_registers)
    return words.view(n_buckets, n_registers)


def _join_pairs(lkey: torch.Tensor, rkey: torch.Tensor):
    """Every index pair (i, j) with ``lkey[i] == rkey[j]``, at most
    ``FM_CHUNK`` pairs at a time: the sorted path's searchsorted ranges,
    expanded a slice of the output at a time."""
    order = torch.argsort(rkey)
    srt = rkey[order]
    lo = torch.searchsorted(srt, lkey, side="left")
    cnt = torch.searchsorted(srt, lkey, side="right") - lo
    ends = torch.cumsum(cnt, 0)
    total = int(ends[-1]) if ends.numel() else 0
    for start in range(0, total, FM_CHUNK):
        pos = torch.arange(start, min(start + FM_CHUNK, total),
                           device=lkey.device)
        i = torch.searchsorted(ends, pos, side="right")
        yield i, order[lo[i] + pos - (ends[i] - cnt[i])]


def _distinct(acc, x: torch.Tensor) -> torch.Tensor:
    return torch.unique(x if acc is None else torch.cat([acc, x]))


def fm_join_registers(r, s, t, *, n_buckets: int = 1,
                      n_registers: int = 32) -> torch.Tensor:
    """FM registers of the distinct (a, d) pairs of R ⋈ S ⋈ T, each row
    joined only within its bucket, ``[n_buckets, n_registers]`` int32.

    ``r = (bucket, a, b)``, ``s = (bucket, b, c)``, ``t = (bucket, c, d)``
    are 1-D int tensors, one entry a row.  The join never forms an
    existence tensor: R ⋈ S on (bucket, b) is expanded in chunks and
    reduced to its distinct (bucket, c, a); those are joined with T on
    (bucket, c) in chunks and reduced to the distinct (bucket, pair key),
    which are folded into the registers once each."""
    (rq, ra, rb), (sq, sb, sc), (tq, tc, td) = r, s, t
    from repro_torch.core import hashing

    def key(q, x):   # (bucket, key) as one int64
        return (q.to(torch.int64) << 32) | hashing._as_u32(x)

    registers = torch.zeros((n_buckets, n_registers), dtype=torch.int32,
                            device=ra.device)
    ckeys, s_cid = torch.unique(key(sq, sc), return_inverse=True)
    ua, r_aid = torch.unique(ra, return_inverse=True)
    na = max(ua.numel(), 1)
    ca = None
    for i, j in _join_pairs(key(rq, rb), key(sq, sb)):
        ca = _distinct(ca, s_cid[j] * na + r_aid[i])
    if ca is None:
        return registers
    a_of = ua[ca % na]
    pairs = None
    for i, j in _join_pairs(ckeys[ca // na], key(tq, tc)):
        pk = ((tq[j].to(torch.int64) << 32)
              | fm_pair_keys(a_of[i], td[j]))
        pairs = _distinct(pairs, pk)
    if pairs is None:
        return registers
    return fm_fold(registers, pairs)


def fm_registers(ra, rv, rb, sb, sc, sv, tc, td, tv, *,
                 n_registers: int = 32):
    """FM sketch registers over the implicit joined (a, d) pairs of each
    bucket, ``[B, K]`` int32: register k of bucket i ORs
    ``key_bits(pair(a, d), k)`` over every (r, t) slot pair of bucket i
    joined through some s slot (s.b = r.b, s.c = t.c).  Operands are
    ``[B, C]`` bucket rows (size-1 or expanded batch rows are read as
    given); invalid slots take their side's sentinel, as the reference's
    do.  Plain torch on every device (the reference computes it outside
    any Pallas kernel), through ``fm_join_registers``: no ``[Cr, Ct]``
    tensor is formed for any bucket."""
    n_buckets = max(ra.shape[0], sb.shape[0], tc.shape[0])

    def rows(*cols):
        cols = [c.expand(n_buckets, c.shape[-1]) for c in cols]
        q = torch.arange(n_buckets, device=cols[0].device)
        return (q[:, None].expand_as(cols[0]).reshape(-1),
                *(c.reshape(-1) for c in cols))

    r = rows(_mask(ra, rv, "r"), _mask(rb, rv, "r"))
    s = rows(_mask(sb, sv, "s"), _mask(sc, sv, "s"))
    t = rows(_mask(tc, tv, "t"), _mask(td, tv, "t"))
    return fm_join_registers(r, s, t, n_buckets=n_buckets,
                             n_registers=n_registers)
