"""The fused partition-sweep ops of the engine's hot path, and their plain
versions.

Each public op masks invalid slots with per-side sentinels (so an invalid
slot can never equal anything on another side) and then dispatches on the
device of its tensors:

  * a CUDA tensor launches the hand-written Hopper kernel
    (``kernels.cuda``); a kernel that fails to build or launch raises —
    there is no fallback,
  * a CPU tensor takes the plain PyTorch version beside it in this module
    (``_fused_linear_ref`` and its siblings).

The reference padded every capacity to 128 lanes for the TPU; the CUDA
kernels take any capacity, so nothing is padded here (padding with
sentinels could not change a count anyway).

Keys must be > SENT_BASE (= -2^31 + 16); the data layer guarantees int32
keys ≥ -2^30.
"""

from __future__ import annotations

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


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _bucket_multiplicity(table: torch.Tensor, probes: torch.Tensor):
    """Per-probe occurrence counts within aligned bucket rows.

    table: [B, Ct] sentinel-masked keys; probes: [B, Cp].  Returns [B, Cp]
    int32 — for each probe, how many equal keys its OWN bucket row holds
    (sorted rows + two batched binary searches per probe).
    """
    srt = torch.sort(table, dim=-1).values
    probes = probes.contiguous()
    lo = torch.searchsorted(srt, probes, side="left")
    hi = torch.searchsorted(srt, probes, side="right")
    return (hi - lo).to(torch.int32)


def _fused_linear_ref(rb, sb, sc, tc):
    """rb [hp,u,Cr], sb/sc [hp,gp,u,Cs], tc [gp,Ct] -> [hp,u] int32.

    Every S slot is weighted by its R multiplicity (probing the matching
    (H, h) bucket) times its T multiplicity (probing the matching g
    bucket), then summed per (H, h).
    """
    hp, u, cr = rb.shape
    _, gp, _, cs = sb.shape
    s_by_r = sb.permute(0, 2, 1, 3).reshape(hp * u, gp * cs)
    wr = _bucket_multiplicity(rb.reshape(hp * u, cr), s_by_r)
    s_by_t = sc.permute(1, 0, 2, 3).reshape(gp, hp * u * cs)
    wt = _bucket_multiplicity(tc, s_by_t)
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
    wt = _bucket_multiplicity(tc, s_by_t).reshape(gp, hp, u, cs)
    wt = wt.permute(1, 2, 0, 3).reshape(hp * u, gp * cs).to(torch.int64)
    keys = sb.permute(0, 2, 1, 3).reshape(hp * u, gp * cs)
    skeys, order = torch.sort(keys, dim=-1, stable=True)
    cw = torch.nn.functional.pad(
        torch.cumsum(torch.gather(wt, 1, order), dim=1), (1, 0))
    probes = rb.reshape(hp * u, cr).contiguous()
    lo = torch.searchsorted(skeys, probes, side="left")
    hi = torch.searchsorted(skeys, probes, side="right")
    out = torch.gather(cw, 1, hi) - torch.gather(cw, 1, lo)
    return out.to(torch.int32).reshape(hp, u, cr)


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


def _fused_cyclic_pairidx_ref(ra, rb, sb, sc, tc, ta):
    """ra/rb [hp,gp,uh,ug,Cr], sb/sc [gp,fp,ug,Cs], tc/ta [hp,fp,uh,Ct]
    -> [hp,gp,uh,ug] int32.

    Per cell (i, j, a, b) and stream bucket f: Σ over (s, r) of
    [s.b = r.b] · #{t : (t.c, t.a) = (s.c, r.a)}.  Realized as a sort join:
    per f, the S slots are sorted by (column bucket (j, b), key b), every R
    slot finds its equal-b S slots in its own column bucket with two
    binary searches, the matching (s, r) pairs are expanded in chunks that
    bound memory, and each pair's T count is the distance between two
    binary searches over the sorted (c, a) pair keys of its T bucket.
    """
    hp, gp, uh, ug, cr = ra.shape
    _, fp, _, cs = sb.shape
    ct = tc.shape[-1]
    dev = ra.device
    tkey = sorted_pair_keys(tc, ta).reshape(-1)          # rows (i, f, a)
    n_cells = hp * gp * uh * ug
    cell = torch.arange(n_cells * cr, device=dev) // cr  # per R slot
    r_i = cell // (gp * uh * ug)
    r_a = (cell // ug) % uh
    r_col = ((cell // (uh * ug)) % gp) * ug + cell % ug  # column bucket (j, b)
    r_key = pair_keys(r_col, rb.reshape(-1))
    ra_flat = ra.reshape(-1)
    s_col = (torch.arange(gp, device=dev)[:, None, None] * ug
             + torch.arange(ug, device=dev)[None, :, None]).expand(gp, ug, cs)
    acc = torch.zeros(n_cells, dtype=torch.int64, device=dev)
    for f in range(fp):
        s_sorted, s_order = torch.sort(
            pair_keys(s_col, sb[:, f]).reshape(-1))
        sc_f = sc[:, f].reshape(-1)
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
            r_idx = torch.repeat_interleave(
                torch.arange(r0, r1, device=dev), n_c)
            first = torch.repeat_interleave(torch.cumsum(n_c, 0) - n_c, n_c)
            rank = torch.arange(r_idx.shape[0], device=dev) - first
            s_idx = s_order[lo[r_idx] + rank]
            q = pair_keys(sc_f[s_idx], ra_flat[r_idx])
            base = ((r_i[r_idx] * fp + f) * uh + r_a[r_idx]) * ct
            cnt = (_row_bisect(tkey, base, ct, q, right=True)
                   - _row_bisect(tkey, base, ct, q, right=False))
            acc.index_add_(0, cell[r_idx], cnt)
            r0 = r1
    return acc.to(torch.int32).reshape(hp, gp, uh, ug)


def _fused_star_ref(rb, sb, sc, tc):
    """rb [uh,Cr], sb/sc [ch,uh,ug,Cs], tc [ug,Ct] -> [uh,ug] int32.

    Same sorted-bucket-probe scheme as ``_fused_linear_ref``: each fact slot
    probes the R bucket of its row and the T bucket of its column.
    """
    uh, cr = rb.shape
    ch, _, ug, cs = sb.shape
    s_by_r = sb.permute(1, 0, 2, 3).reshape(uh, ch * ug * cs)
    wr = _bucket_multiplicity(rb, s_by_r)
    wr = wr.reshape(uh, ch, ug, cs).permute(1, 0, 2, 3)   # [ch,uh,ug,cs]
    s_by_t = sc.permute(2, 0, 1, 3).reshape(ug, ch * uh * cs)
    wt = _bucket_multiplicity(tc, s_by_t)
    wt = wt.reshape(ug, ch, uh, cs).permute(1, 2, 0, 3)   # [ch,uh,ug,cs]
    return _sum_int32(wr * wt, (0, 3))


# --------------------------------------------------------------------------
# the ops: mask, then kernel (CUDA) or plain version (CPU)
# --------------------------------------------------------------------------

def fused_count3_linear(rb, rv, sb, sc, sv, tc, tv):
    """Fused linear-3 sweep: per-(H, h) bucket counts [hp, u] int32."""
    rb = _mask(rb, rv, "r")
    sb = _mask(sb, sv, "s")
    sc = _mask(sc, sv, "s")
    tc = _mask(tc, tv, "t")
    if _on_cuda(rb, "fused_count3_linear"):
        from repro_torch.kernels import cuda
        return cuda.fused_count3_linear(rb, sb, sc, tc)
    return _fused_linear_ref(rb, sb, sc, tc)


def fused_per_r_counts(rb, rv, sb, sc, sv, tc, tv):
    """Fused per-R-slot counts [hp, u, Cr] int32 (Example 1 aggregate)."""
    rb = _mask(rb, rv, "r")
    sb = _mask(sb, sv, "s")
    sc = _mask(sc, sv, "s")
    tc = _mask(tc, tv, "t")
    if _on_cuda(rb, "fused_per_r_counts"):
        from repro_torch.kernels import cuda
        return cuda.fused_per_r_counts(rb, sb, sc, tc)
    return _fused_per_r_ref(rb, sb, sc, tc)


def fused_count3_cyclic(ra, rb, rv, sb, sc, sv, tc, ta, tv, *,
                        pair_index: bool = True):
    """Fused cyclic sweep: per-cell counts [hp, gp, uh, ug] int32.

    ``pair_index=True`` (the session's path) probes a sorted (c, a)-pair
    index of the T stream.  ``pair_index=False`` is the all-pairs
    contraction, whose Hopper kernel is not written yet (ROADMAP Queue B,
    "all-pairs cyclic kernel"): on a CUDA tensor it raises instead of
    quietly running something else.  On the CPU both forms compute the
    same per-cell counts, so both take the one plain version.
    """
    ra = _mask(ra, rv, "r")
    rb = _mask(rb, rv, "r")
    sb = _mask(sb, sv, "s")
    sc = _mask(sc, sv, "s")
    tc = _mask(tc, tv, "t")
    ta = _mask(ta, tv, "t")
    on_cuda = _on_cuda(ra, "fused_count3_cyclic")
    if not pair_index:
        if on_cuda:
            raise NotImplementedError(
                "fused_count3_cyclic(pair_index=False): the all-pairs cyclic "
                "kernel has no Hopper port yet (ROADMAP Queue B, all-pairs "
                "cyclic kernel); use pair_index=True")
    if on_cuda:
        from repro_torch.kernels import cuda
        return cuda.fused_count3_cyclic_pairidx(
            ra, rb, sb, sc, sorted_pair_keys(tc, ta))
    return _fused_cyclic_pairidx_ref(ra, rb, sb, sc, tc, ta)


def fused_count3_star(rb, rv, sb, sc, sv, tc, tv):
    """Fused star sweep: per-PMU counts [uh, ug] int32."""
    rb = _mask(rb, rv, "r")
    sb = _mask(sb, sv, "s")
    sc = _mask(sc, sv, "s")
    tc = _mask(tc, tv, "t")
    if _on_cuda(rb, "fused_count3_star"):
        from repro_torch.kernels import cuda
        return cuda.fused_count3_star(rb, sb, sc, tc)
    return _fused_star_ref(rb, sb, sc, tc)
