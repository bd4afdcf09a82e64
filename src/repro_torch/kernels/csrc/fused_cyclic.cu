// fused_count3_cyclic (the all-pairs form) on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/bucket_join.py:317
// fused_count3_cyclic (_fused_cyclic_kernel, :296): the whole triangle
// sweep over the H(A) x G(B) coarse grid, the uh x ug PMU grid and the
// f(C) stream, grid (hp, gp, uh, ug, fp), per step Σ (M1ᵀ·M2) ⊙ M3 on the
// MXU in f32, summed over f into an int32 cell.
//
// Here the batch is the same five dimensions; R rows are the cells
// (i, j, a, b), S rows (j, f, b) and T rows (i, f, a) are addressed by
// row strides that ignore the other dimensions, and the output cell
// ignores f, so the sum over f happens in the atomics.  The device code
// (cyclic_allpairs.cuh) is a merge join on c per R slot and f, shared
// with bucket_count3_cyclic; it is not the pair-index kernel
// (fused_cyclic_pairidx.cu), which searches per S slot.
// Bound: the search and merge steps per R slot and f (about 4 log2(C) +
// |S run| + |T run|).
#include "cyclic_allpairs.cuh"

extern "C" int rj_fused_cyclic(const int* ra, const int* rb,
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
