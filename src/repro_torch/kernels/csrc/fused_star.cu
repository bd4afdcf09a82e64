// fused_count3_star on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/bucket_join.py:425
// fused_count3_star (_fused_star_kernel, :409): the star 3-way sweep with
// dimension R(aB) pinned by row bucket h(B), dimension T(Cd) pinned by
// column bucket g(C), and the fact relation S(BC) streamed in arrival-order
// chunks.  Operands: R [uh, Cr], S [ch, uh, ug, Cs], T [ug, Ct] int32 keys
// with their bool validity.  For every live S slot (chunk, h, g, k):
//     wr = #{R slots of bucket h with b == s.b}
//     wt = #{T slots of bucket g with c == s.c}
// and out[h, g] += wr * wt  (int32).
//
// The Pallas grid (uh, ug, chunks) has only uh*ug*chunks programs (64 at
// the default plan), which cannot fill 132 SMs, and each program compares
// its whole S cell (Cs = 781,256 slots at a 2e7-row fact table) against
// whole R and T buckets (31,256 slots each).  Here:
//   0. the pre-pass (key_lists.cuh) turns each R row and each T row into a
//      (key, count) list, reading the validity itself, and every R list
//      into a hash table in global memory (twice the row's slots: ~4 MB
//      for Q2's 8 rows, resident in the 50 MB L2).  A T list past half
//      the sweep's shared table goes into a global table too, and its
//      distinct keys are counted (a list holds a key once per 2,048-slot
//      segment it occurs in: ~12,400 entries at Q2 for ~7,900 keys);
//   1. the split sweep of sweep_common.cuh (StarCells), which the bucket-
//      row sweep of the star baseline shares: one CTA of 1,024 threads per
//      (g, split) stages g's list in a shared count table of up to 8,192
//      slots (64 KB, so two CTAs share an SM) once, or reads g's global
//      table when its distinct keys pass half of that, as Q2's do.  A
//      16,384-slot table would hold Q2's rows but leave one CTA an SM, and
//      the sweep is slower that way than with both tables in L2 at twice
//      the warps (tools/star_variants.py, on an H100): its probes wait on
//      memory, so warps in flight count for more than where the table
//      sits;
//   2. it sweeps split j of every cell (chunk, h, g) of column g: each
//      cell's Cs slots are cut into `splits` contiguous ranges (enough
//      CTAs for one wave on 132 SMs), read coalesced.  Each warp queues
//      its live slots in shared memory and probes 32 at a time (T, then
//      R's global table where wt != 0), so every lane carries a live
//      slot; the warp sums wr * wt in registers and adds the sum to
//      out[h, g] with one atomic per cell.
// Every S slot is read once; slot indices within a cell are 32-bit, with
// no division per slot.  Counts are unsigned 32-bit and wrap as the
// reference's int32.
// Bound: the bytes, chiefly the S grid read once (about 450 MB at Q2).
#include "sweep_common.cuh"

// Scratch from the caller: rkc [uh, cr] int2, tkc [ug, ct] int2, rtab
// [uh, 2 * cr] int2 and ttab [ug, 2 * ct] int2 (uninitialised); rlen
// [uh], tlen and tdist [ug] int32 zeroed; out [uh, ug] int32 zeroed.
extern "C" int rj_fused_star(const int* rb, const unsigned char* rv,
                             const int* sb, const int* sc,
                             const unsigned char* sv, const int* tc,
                             const unsigned char* tv, long long ch,
                             long long uh, long long ug, long long cr,
                             long long cs, long long ct, void* rkc,
                             int* rlen, void* tkc, int* tlen, int* tdist,
                             void* rtab, void* ttab, int* out, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ch * uh * ug == 0 || cr == 0 || cs == 0 || ct == 0)
    return (int)cudaSuccess;
  if (2 * cr > 0x7fffffffLL || 2 * ct > 0x7fffffffLL || cs > 0x3fffffffLL ||
      ch > 0x7fffffffLL || uh > 0x7fffffffLL || ug > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  int2* r_lists = static_cast<int2*>(rkc);
  int2* t_lists = static_cast<int2*>(tkc);
  int2* r_tabs = static_cast<int2*>(rtab);
  int2* t_tabs = static_cast<int2*>(ttab);
  const int tslots = rj::split_tslots(ct);
  const unsigned r_cap = (unsigned)(2 * cr), t_cap = (unsigned)(2 * ct);
  // every R list into its global table; T's past the shared budget
  err = rj::count_keys(rb, rv, uh, cr, 0, true, r_lists, nullptr, rlen, st);
  if (err == cudaSuccess)
    err = rj::count_keys(tc, tv, ug, ct, 0, true, t_lists, nullptr, tlen, st);
  if (err == cudaSuccess)
    err = rj::spill(r_lists, nullptr, rlen, uh, cr, 0, 1, r_cap, r_tabs,
                    nullptr, st);
  if (err == cudaSuccess)
    err = rj::spill(t_lists, nullptr, tlen, ug, ct, tslots / 2, 1, t_cap,
                    t_tabs, tdist, st);
  if (err != cudaSuccess) return (int)err;
  const rj::StarCells cells{(int)ch, (int)uh, (int)ug};
  return (int)rj::launch_split_sweep(cells, r_tabs, r_cap, rlen, sb, sc, sv,
                                     t_lists, tlen, tdist, ct, t_tabs, t_cap,
                                     cs, out, device, st);
}
