"""Appendix-A performance model: loop-tree runtime estimation.

Implements the paper's Fig 5/6 semantics analytically:

  #par[P]        loop work divided over P units
  #pipeline      outer iterations overlap: per-iteration time is
                 max(stage times) (double-buffered prefetch, §6.2)
  #streaming     producer/consumer overlap: total time is
                 max(stream times) + latency
  branch p       data-dependent body weighted by hit probability
                 (e.g. the S·T match branch hits with p = g/d, App. A)

Compute semantics: joins are *bucket probes*.  A streamed tuple is compared
SIMD-wide against the bucket it hashes to; bucketing can divide work only
down to duplicate groups (|rel|/d tuples share one key, and every one is a
real match that must be touched).  This reproduces the paper's footnote-10
comparison counts |R||S|/h + |R||S||T|/(d·g) including their implicit
duplicate floor, and the Fig 4 bottleneck shifts (compute-bound at small
bucket counts → stream-bound at large; response-time cliff when buckets
shrink below a DRAM burst).

The cascade materializes I(ABC) = R⋈S to DRAM — and to SSD once it exceeds
DRAM capacity (the Fig 4 e/f step).  Everything else aggregates on the fly
(COUNT / FM sketch) per §6.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.perfmodel.hw import HW


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

def dram_time(total_bytes: float, hw: HW, chunk_bytes: float | None = None,
              bw: float | None = None) -> float:
    """Bandwidth + per-chunk response; sub-burst chunks pay full bursts."""
    if total_bytes <= 0:
        return 0.0
    bw = bw or hw.dram_bw
    if chunk_bytes is None or chunk_bytes <= 0:
        return total_bytes / bw
    eff_chunk = max(chunk_bytes, 1.0)
    n_chunks = total_bytes / eff_chunk
    padded = max(eff_chunk, hw.dram_burst) * n_chunks
    return padded / bw + n_chunks * hw.dram_resp_s


def probe_time(n_probes: float, other_n: float, fanout: float, d: float,
               hw: HW) -> float:
    """Probe `other` (hash-bucketed `fanout` ways, floored at duplicate
    groups of other_n/d) once per streamed tuple, SIMD-wide scans, U
    probes in flight."""
    if n_probes <= 0 or other_n <= 0:
        return 0.0
    eff_fanout = min(max(fanout, 1.0), max(d, 1.0))
    bucket = other_n / eff_fanout
    cycles_per_probe = max(1.0, bucket / hw.simd)
    return n_probes * cycles_per_probe / (hw.u * hw.freq)


def sync_latency(iters: float, hw: HW) -> float:
    """Per-iteration barrier: all PCUs share the streamed records, so each
    bucket iteration ends with a network+pipeline sync (App. A)."""
    return iters * (hw.net_lat_cycles + hw.pipe_lat_cycles) / hw.freq


@dataclasses.dataclass
class Breakdown:
    """Seconds by phase + the dominant stage marker (Fig 4 annotations)."""
    partition: float
    join1: float
    join2: float
    stages: dict

    @property
    def total(self) -> float:
        return self.partition + self.join1 + self.join2

    @property
    def bottleneck(self) -> str:
        return max(self.stages, key=self.stages.get)

    def to_json(self):
        return {"partition_s": self.partition, "join1_s": self.join1,
                "join2_s": self.join2, "total_s": self.total,
                "bottleneck": self.bottleneck,
                "stages": dict(self.stages)}


def _partition_pass(n_tuples: float, hw: HW, bw: float | None = None
                    ) -> float:
    """One radix pass = stream in + scatter out (2× bytes over DRAM)."""
    return dram_time(2.0 * n_tuples * hw.tuple_bytes, hw, bw=bw)


# --------------------------------------------------------------------------
# cascaded binary join (§6.3, Fig 6 b/d)
# --------------------------------------------------------------------------

def binary_cascade_time(n_r: float, n_s: float, n_t: float, d: float,
                        hw: HW, h_bkt: float | None = None,
                        g_bkt: float | None = None) -> Breakdown:
    """R ⋈ S → I (materialized), then I ⋈ T → aggregate.

    `h_bkt`/`g_bkt` are the coarse partition counts the paper sweeps in
    Fig 4 a/b; the fine level is fixed at h = g = U (§6.3).  Defaults pick
    the best value (large enough that probes hit the duplicate floor).
    """
    tb = hw.tuple_bytes
    n_i = n_r * n_s / d                       # |I| (Swami–Schiefer)
    h_bkt = h_bkt if h_bkt is not None else max(1.0, d / hw.u)
    g_bkt = g_bkt if g_bkt is not None else max(1.0, d / hw.u)
    spill = n_i * tb > hw.dram_cap
    io_bw = hw.spill_bw if spill else hw.dram_bw

    # partition: R,S by B; T by C; I re-partitioned by C (round trip
    # included in join1 write / join2 read, so only one extra scatter pass)
    t_part = _partition_pass(n_r + n_s + n_t, hw)

    # --- join 1: R partitions pinned, S streamed, I written --------------
    t1_compute = probe_time(n_s, n_r, h_bkt * hw.u, d, hw)
    t1_read = dram_time((n_r + n_s) * tb, hw)
    t1_write = dram_time(n_i * tb, hw, bw=io_bw)
    if spill:   # SSD is a separate interface: overlaps with DRAM reads
        t1 = max(t1_read, t1_compute, t1_write)
    else:       # write contends with reads on the one DRAM interface
        t1 = max(dram_time((n_r + n_s + n_i) * tb, hw), t1_compute)
    b1 = {"j1_stream_RS": t1_read, "j1_comp": t1_compute,
          "j1_store_I": t1_write}

    # --- join 2: T partitions pinned, I streamed, COUNT on the fly -------
    t2_compute = probe_time(n_i, n_t, g_bkt * hw.u, d, hw)
    t2_read_i = dram_time(n_i * tb, hw, bw=io_bw)
    t2_load_t = dram_time(n_t * tb, hw, chunk_bytes=n_t / g_bkt * tb)
    t2 = max(t2_read_i, t2_compute) + t2_load_t + sync_latency(g_bkt, hw)
    b2 = {"j2_stream_I": t2_read_i, "j2_comp": t2_compute,
          "j2_load_T": t2_load_t}

    stages = {"partition": t_part, **b1, **b2}
    return Breakdown(t_part, t1, t2, stages)


def cpu_cascade_time(n_r: float, n_s: float, n_t: float, d: float,
                     hw: HW) -> Breakdown:
    """Single-threaded CPU (Postgres-class) hash join: one probe chain,
    `cpu_probe_s` per tuple touch (bucket locate + every duplicate match),
    intermediate spills past RAM."""
    n_i = n_r * n_s / d
    c = hw.cpu_probe_s
    dup_r = max(1.0, n_r / d)
    dup_t = max(1.0, n_t / d)
    spill = n_i * hw.tuple_bytes > hw.dram_cap
    io_bw = hw.spill_bw if spill else hw.dram_bw
    # join1: build R, probe each S tuple (touching its dup_r matches)
    t1 = (n_r + n_s * (1.0 + dup_r)) * c \
        + dram_time(n_i * hw.tuple_bytes, hw, bw=io_bw)
    # join2: build T, probe each I tuple (touching its dup_t matches)
    t2 = (n_t + n_i * (1.0 + dup_t)) * c \
        + dram_time(n_i * hw.tuple_bytes, hw, bw=io_bw)
    stages = {"cpu_j1": t1, "cpu_j2": t2}
    return Breakdown(0.0, t1, t2, stages)


# --------------------------------------------------------------------------
# linear 3-way self join (§4, Fig 6 a)
# --------------------------------------------------------------------------

def linear3_time(n_r: float, n_s: float, n_t: float, d: float, hw: HW,
                 h_bkt: float | None = None, g_bkt: float | None = None
                 ) -> Breakdown:
    """Algorithm 1 runtime.

    for H(B) partition of R (sized to fit on-chip): load R_i;
      for g(C) bucket: load S_ij (routed by h(B)), broadcast-stream T_j;
        compare each t against the PMU-local S_ij records sharing g(c)
        (all-pairs within the bucket, floored at the |S|/d duplicate
        group); on a hit (p = g/d) join against the R_i records with the
        matching B (|R|/d duplicates, SIMD-wide).
    """
    tb = hw.tuple_bytes
    m = hw.m_tuples
    min_h = max(1, int(math.ceil(n_r / m)))
    h_bkt = max(h_bkt or min_h, min_h)
    if g_bkt is None:    # "with best bucket sizes" (§6): line-search g
        best = None
        g = 16.0
        while g <= 4 * max(d, hw.u):
            t = linear3_time(n_r, n_s, n_t, d, hw, h_bkt=h_bkt, g_bkt=g)
            if best is None or t.total < best[0]:
                best = (t.total, g)
            g *= 4.0
        g_bkt = best[1]

    t_part = _partition_pass(n_r + n_s + n_t, hw)

    s_ij = n_s / (h_bkt * g_bkt)                  # S bucket per iteration
    t_j = n_t / g_bkt
    # S·T compare: each streamed t scans the per-PMU S_ij slice SIMD-wide
    # (all-pairs within the g(C) bucket, floored at duplicate groups)
    t_comp_st_iter = probe_time(t_j, s_ij * h_bkt * g_bkt,
                                h_bkt * g_bkt * hw.u, d, hw) \
        / (h_bkt * g_bkt)
    # branch hits join against R's B-duplicates
    hits_iter = s_ij * t_j * (min(g_bkt, d) / d) if d else 0.0
    t_comp_r_iter = hits_iter * max(1.0, (n_r / d) / hw.simd) \
        / (hw.u * hw.freq)
    t_comp_iter = t_comp_st_iter + t_comp_r_iter

    # DRAM per iteration: buckets stream contiguously (the on-chip network
    # does the h(B) routing — that is the point of the fabric); a bucket
    # below a DRAM burst still pays the response-time cliff (Fig 4d).
    t_dram_iter = dram_time(s_ij * tb, hw, chunk_bytes=s_ij * tb) \
        + dram_time(t_j * tb, hw, chunk_bytes=t_j * tb)
    t_iter = max(t_comp_iter, t_dram_iter)        # double-buffered
    t_load_r = dram_time((n_r / h_bkt) * tb, hw)
    t_join = h_bkt * (t_load_r + g_bkt * t_iter) \
        + sync_latency(h_bkt * g_bkt, hw)

    stages = {
        "partition": t_part,
        "comp": h_bkt * g_bkt * t_comp_iter,
        "stream_T": h_bkt * g_bkt * dram_time(t_j * tb, hw,
                                              chunk_bytes=t_j * tb),
        "load_S": h_bkt * g_bkt * dram_time(s_ij * tb, hw,
                                            chunk_bytes=s_ij * tb),
        "load_R": h_bkt * t_load_r,
        "sync": sync_latency(h_bkt * g_bkt, hw),
    }
    return Breakdown(t_part, t_join, 0.0, stages)


# --------------------------------------------------------------------------
# star 3-way join (§6.5, Fig 6 c/d): R,T small, S streamed once
# --------------------------------------------------------------------------

def star3_time(n_r: float, n_s: float, n_t: float, d: float, hw: HW,
               h_bkt: float | None = None) -> Breakdown:
    """3-way star: R,T pinned at PMU (h(b), g(c)) pairs (h·g = U), S
    streamed once; each fact tuple probes both dimension buckets (duplicate
    floor n_r/d — dimension keys are near-unique, d ≈ |R|)."""
    hg = hw.u
    h = h_bkt or int(math.sqrt(hg))
    g = max(1, hg // int(h))
    del g
    tb = hw.tuple_bytes

    t_load_dims = dram_time((n_r + n_t) * tb, hw)
    t_stream_s = dram_time(n_s * tb, hw)
    # PMU-resident dimension buckets are hash-organized at build time:
    # a fact probe touches O(1) + its duplicate group (n/d)
    t_comp = probe_time(n_s, n_r, d, d, hw) + probe_time(n_s, n_t, d, d, hw)
    t_join = max(t_stream_s, t_comp) + t_load_dims
    stages = {"load_dims": t_load_dims, "stream_S": t_stream_s,
              "comp": t_comp}
    return Breakdown(0.0, t_join, 0.0, stages)


def star3_binary_time(n_r: float, n_s: float, n_t: float, d: float,
                      hw: HW) -> Breakdown:
    """Cascaded binary plan for the star schema: (R ⋈ S) ⋈ T with
    h = g = U (one hash at a time, §6.5).  I = |S|·(|R|/d) — below-one
    selectivity only if facts miss dimensions; with duplicates |R|/d > 1
    the intermediate *expands*, which is what the 3-way avoids."""
    dup = n_r / d if d else 1.0
    n_i = n_s * dup
    tb = hw.tuple_bytes
    spill = n_i * tb > hw.dram_cap
    io_bw = hw.spill_bw if spill else hw.dram_bw

    t_load_r = dram_time(n_r * tb, hw)
    t1_comp = probe_time(n_s, n_r, d, d, hw)
    t1_io_in = dram_time(n_s * tb, hw)
    t1_write = dram_time(n_i * tb, hw, bw=io_bw)
    t1 = (max(t1_io_in, t1_comp, t1_write) if spill
          else max(dram_time((n_s + n_i) * tb, hw), t1_comp)) + t_load_r

    t_load_t = dram_time(n_t * tb, hw)
    t2_comp = probe_time(n_i, n_t, d, d, hw)
    t2_read = dram_time(n_i * tb, hw, bw=io_bw)
    t2 = max(t2_read, t2_comp) + t_load_t
    stages = {"sj1_io": t1_io_in + t1_write, "sj1_comp": t1_comp,
              "sj2_io": t2_read, "sj2_comp": t2_comp,
              "load_dims": t_load_r + t_load_t}
    return Breakdown(0.0, t1, t2, stages)
