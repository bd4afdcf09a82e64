// bucket_count3_cyclic on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/bucket_join.py:164
// count3_cyclic (_count3_cyclic_kernel, :148): per bucket row, the
// triangle count Σ_{r,s,t} [r.b == s.b][s.c == t.c][t.a == r.a].  The
// Pallas grid has one program per bucket row; the scan driver
// (core/cyclic3.py) launched it once per (i, j, f) step with the S row
// broadcast down the grid's columns and the T row across its rows.
//
// Here the bucket rows are a batch of up to five dimensions in which an
// operand may be one row shared along a dimension, so the scan driver
// launches once per (i, j) cell with the f loop as the batch and no S or
// T row copied.  The device code (cyclic_allpairs.cuh) is a merge join on
// c per R slot, shared with fused_count3_cyclic.
// Bound: the search and merge steps per R slot (about 4 log2(C) +
// |S run| + |T run|); the rows are read once, and stay in L2.
#include "cyclic_allpairs.cuh"

extern "C" int rj_bucket_cyclic(const int* ra, const int* rb,
                                const long long* skey, const long long* tkey,
                                int dead_r, int nd, const long long* dims,
                                const long long* r, const long long* s,
                                const long long* t, const long long* o,
                                long long cr, long long cs, long long ct,
                                int* out, int device, void* stream) {
  return (int)rj::launch_cyclic_merge(ra, rb, skey, tkey, dead_r, nd, dims, r,
                                      s, t, o, cr, cs, ct, out, device,
                                      static_cast<cudaStream_t>(stream));
}
