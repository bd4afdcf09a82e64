#!/usr/bin/env python3
"""Time variants of the star sweep (``csrc/fused_star.cu``) on the card.

    python3 tools/star_variants.py [--seed N]

Builds each variant of this checkout's ``fused_star.cu`` with nvcc (the
flags of ``kernels.cuda``), swaps its library in for the built one and
times ``ops.fused_count3_star`` at Q2's round-1 layout (the smoke's star
data, planned by ``JoinSession(m_budget=16384).execute``), in two turns
(the second in reverse order).  Per variant and turn: ``op_ms`` (median of
5 CUDA-event timings), ``kernel_ms`` and ``sweep_ms`` (``torch.profiler``,
``chip_smoke.kernel_ms``), the sum of the counts and whether the counts
equal the built kernel's.  The variants:

  base       the kernel as built (T's shared table up to 8,192 slots, so
             Q2's rows of ~7,900 keys take the global table);
  t16k       T's shared table up to 16,384 slots (128 KB: Q2's rows fit,
             one CTA an SM);
  t16k_ilp2  t16k with each lane probing two queued slots, their probe
             loops interleaved;
  prefetch   base with each warp's next slots loaded before it probes;
  no_r       base without R's probes (wrong counts: a diagnostic);
  no_probe   base without T's and R's probes (wrong counts: the streaming
             and queueing alone).

Each variant is a text edit of the source that must apply exactly, so the
script fails loudly once the kernel changes under it.  Prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _rep(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"star_variants: the source no longer holds "
                         f"{old[:60]!r}")
    return text.replace(old, new)


LOOP_PREFETCH = '''      const int step = kStarThreads * kStarRounds;
      bool nlive[kStarRounds];
      int nb[kStarRounds], nc[kStarRounds];
      int k0 = warp * kStarRounds * 32;
#pragma unroll
      for (int it = 0; it < kStarRounds; ++it) {
        const int k = k0 + it * 32 + lane;
        nlive[it] = k < n_split && sv[base + k] != 0;
        nb[it] = k < n_split ? sb[base + k] : 0;
        nc[it] = k < n_split ? sc[base + k] : 0;
      }
      for (; k0 < n_split; k0 += step) {
        bool live[kStarRounds];
        int b[kStarRounds], c[kStarRounds];
#pragma unroll
        for (int it = 0; it < kStarRounds; ++it) {
          live[it] = nlive[it];
          b[it] = nb[it];
          c[it] = nc[it];
          const int k = k0 + step + it * 32 + lane;
          nlive[it] = k < n_split && sv[base + k] != 0;
          nb[it] = k < n_split ? sb[base + k] : 0;
          nc[it] = k < n_split ? sc[base + k] : 0;
        }
'''

PROBE_ILP2 = '''// wr * wt of the queued slots head .. head + n - 1 (n <= 64), two a
// lane, their probe loops interleaved.
__device__ __forceinline__ unsigned star_probe(
    const int* qb, const int* qc, int head, int n, const int* t_key,
    const unsigned* t_cnt, unsigned t_mask, const int2* t_glob,
    unsigned t_cap, const int2* r_tab, unsigned r_cap) {
  const int lane = threadIdx.x & 31;
  const bool on0 = lane < n, on1 = lane + 32 < n;
  const int q0 = (head + lane) & (kStarQueue - 1);
  const int q1 = (head + lane + 32) & (kStarQueue - 1);
  const int c0 = on0 ? qc[q0] : 0, c1 = on1 ? qc[q1] : 0;
  const int b0 = on0 ? qb[q0] : 0, b1 = on1 ? qb[q1] : 0;
  unsigned w0 = 0u, w1 = 0u;
  bool d0 = !on0, d1 = !on1;
  if (t_glob == nullptr) {
    unsigned s0 = hash_key(c0) & t_mask, s1 = hash_key(c1) & t_mask;
    while (!(d0 && d1)) {
      const int x0 = d0 ? 0 : t_key[s0];
      const int x1 = d1 ? 0 : t_key[s1];
      if (!d0) {
        if (x0 == c0) { w0 = t_cnt[s0]; d0 = true; }
        else if (x0 == kEmptyKey) d0 = true;
        else s0 = (s0 + 1) & t_mask;
      }
      if (!d1) {
        if (x1 == c1) { w1 = t_cnt[s1]; d1 = true; }
        else if (x1 == kEmptyKey) d1 = true;
        else s1 = (s1 + 1) & t_mask;
      }
    }
  } else {
    w0 = on0 ? entry_count(t_glob, t_cap, c0, hash_key(c0)) : 0u;
    w1 = on1 ? entry_count(t_glob, t_cap, c1, hash_key(c1)) : 0u;
  }
  unsigned r0 = 0u, r1 = 0u;
  d0 = w0 == 0u;
  d1 = w1 == 0u;
  unsigned s0 = __umulhi(hash_key(b0), r_cap);
  unsigned s1 = __umulhi(hash_key(b1), r_cap);
  while (!(d0 && d1)) {
    const int2 x0 = d0 ? make_int2(0, 0) : r_tab[s0];
    const int2 x1 = d1 ? make_int2(0, 0) : r_tab[s1];
    if (!d0) {
      if (x0.x == b0) { r0 = x0.y; d0 = true; }
      else if (x0.x == kEmptyKey) d0 = true;
      else s0 = s0 + 1u == r_cap ? 0u : s0 + 1u;
    }
    if (!d1) {
      if (x1.x == b1) { r1 = x1.y; d1 = true; }
      else if (x1.x == kEmptyKey) d1 = true;
      else s1 = s1 + 1u == r_cap ? 0u : s1 + 1u;
    }
  }
  return w0 * r0 + w1 * r1;
}

'''

R_PROBE = "  return wt * entry_count(r_tab, r_cap, b, hash_key(b));"
T_PROBE = '''  const unsigned wt = t_glob != nullptr
                          ? entry_count(t_glob, t_cap, c, hash_key(c))
                          : table_get(t_key, t_cnt, t_mask, c, hash_key(c));'''


def variants(src: str) -> dict:
    t16k = _rep(src, "constexpr int kStarTMax = 8192;",
                "constexpr int kStarTMax = 16384;")
    loop = src[src.index("      for (int k0 = warp * kStarRounds * 32;"):
               src.index("#pragma unroll\n        for (int it = 0; it < "
                         "kStarRounds; ++it) {\n          const unsigned m")]
    probe = src[src.index("// wr * wt of the queued slots"):
                src.index("// rtab: R's global tables")]
    ilp2 = t16k
    for old, new in ((probe, PROBE_ILP2),
                     ("constexpr int kStarQueue = 64;",
                      "constexpr int kStarQueue = 128;"),
                     ("if (tail - head >= 32) {", "if (tail - head >= 64) {"),
                     ("v += star_probe(qb, qc, head, 32,",
                      "v += star_probe(qb, qc, head, 64,"),
                     ("head += 32;", "head += 64;")):
        ilp2 = _rep(ilp2, old, new)
    return {
        "base": src,
        "t16k": t16k,
        "t16k_ilp2": ilp2,
        "prefetch": _rep(src, loop, LOOP_PREFETCH),
        "no_r": _rep(src, R_PROBE, "  return wt + (unsigned)b;"),
        "no_probe": _rep(_rep(src, T_PROBE,
                              "  const unsigned wt = (unsigned)c | 1u;"),
                         R_PROBE, "  return wt + (unsigned)b;"),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("star_variants: needs a CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.convert import relation_from_numpy
    from repro_torch.core.query import Query
    from repro_torch.core.session import JoinSession
    from repro_torch.kernels import cuda, ops
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "build_s": cuda.build()}), flush=True)

    out_dir = ROOT / "build" / "star_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants((cuda.CSRC / "fused_star.cu").read_text()).items():
        cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    fn, argtypes = cuda._LIBS["fused_star"]
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"star_variants: {name} failed to build:\n{log}")
        lib = ctypes.CDLL(str(so))
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
        lib.rj_error_string.argtypes = [ctypes.c_int]
        lib.rj_error_string.restype = ctypes.c_char_p
        libs[name] = lib

    data = smoke.make_data(args.seed)
    q = Query({k: relation_from_numpy(v) for k, v in data["star"].items()},
              [("r.b", "s.b"), ("s.c", "t.c")])
    res = JoinSession(m_budget=smoke.M_BUDGET).execute(q, strategy="3way")
    _, (rg, sg, tg), cols = smoke.first_round_layout(
        {("Q2", "3way"): res}, {"Q2": q}, "Q2", "3way")
    a = (rg.columns[cols["rb"]], rg.valid, sg.columns[cols["sb"]],
         sg.columns[cols["sc"]], sg.valid, tg.columns[cols["tc"]], tg.valid)
    built = cuda._loaded["fused_star"]
    want = ops.fused_count3_star(*a)

    def run():
        return ops.fused_count3_star(*a)
    try:
        for turn, order in enumerate((list(libs), list(libs)[::-1])):
            for name in order:
                cuda._loaded["fused_star"] = libs[name]
                got = run()
                k_ms, by_name, _ = smoke.kernel_ms(torch, run)
                print(json.dumps({
                    "variant": name, "turn": turn,
                    "op_ms": smoke.time_ms(torch, run), "kernel_ms": k_ms,
                    "sweep_ms": sum(v for k, v in by_name.items()
                                    if "star_sweep" in k),
                    "sum": int(got.to(torch.int64).sum()),
                    "equals_built": bool(torch.equal(got, want))}),
                    flush=True)
    finally:
        cuda._loaded["fused_star"] = built
    return 0


if __name__ == "__main__":
    sys.exit(main())
