"""Build, load and launch the hand-written Hopper kernels.

The CUDA C++ sources under ``csrc/`` are compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into one shared library per
source, each with a plain C interface, and loaded with ``ctypes``.  The
libraries go to ``_build/<hash>/`` beside this file (listed in
``.gitignore``), keyed by a hash of the sources and the flags, so an edit
rebuilds and an unchanged checkout reuses them.  All sources compile in
parallel, one ``nvcc`` each.

Each wrapper checks device, dtype, shape and contiguity, allocates the
output and any scratch with torch, launches on PyTorch's current stream,
raises on the ``cudaGetLastError()`` code the C function returns, and adds
one to its launch counter (``LAUNCHES``).  Nothing here falls back to a
plain version: a build or launch failure raises.

Every join kernel (the fused sweeps of the session's path, linear,
per-R, star and pair-index; the all-pairs cyclic sweep; the bucket-row
pair count, linear, per-R and cyclic sweeps of the baselines) takes the
raw key columns and their bool validity masks: its pre-pass drops dead
slots and builds the tables it probes, in shared memory where they fit,
so nothing is sorted or masked around it; the wrappers allocate the
pre-passes' scratch.  The three triangle ops run one sweep, one library
(``csrc/cyclic_sweep.cu``), over a batch described by its dimensions and
each operand's row strides; each op keeps its own launch counter.

The flash forward (``flash_fwd``, the LM's prefill and training
attention) takes f32 or bf16 q, k, v through their strides and returns
o, m, l; the flash backward (``flash_bwd``) takes q, k, v, do through
their strides with o, m, l and returns dq, dk, dv; the radix histogram
(``radix_histogram``) takes an int32 key stream and its bool validity,
any contiguous view of them.  None is masked with sentinels.

The bucket-row wrappers (``bucket_*``) take ``[*batch, C]`` rows whose
batch shapes broadcast: an operand of size 1 along a batch dimension is
one row shared along it, passed to the kernel once with a zero row
stride (or without that dimension's bit in its span mask) and listed or
packed once per launch, never copied per bucket.  The wrappers of the
pair count, the bucket-row sweeps, the triangle sweeps and the radix
histogram allocate their outputs uninitialised: the C code zeroes them
or writes every slot.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

from repro_torch.core.hashing import _SEEDS

_HERE = pathlib.Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_ROOT = _HERE / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_longlong
_C = ctypes.c_int
_A = ctypes.POINTER(ctypes.c_longlong)   # a host array of int64

# source stem -> (exported function, argtypes).  Pointer and stream
# arguments are c_void_p and sizes c_longlong, so ctypes passes no pointer
# as a 32-bit int.
# the triangle sweeps: nine operands (keys and validity), the batch and
# four stride arrays, three capacities, two scratch tensors and the output
_CYCLIC_ARGS = [*[_P] * 9, _C, *[_A] * 5, *[_I] * 3, *[_P] * 3, _C, _P]
# the linear, per-R and star sweeps: seven operands (keys and validity),
# six sizes, seven scratch tensors and the output
_SWEEP_ARGS = [*[_P] * 7, *[_I] * 6, *[_P] * 8, _C, _P]
# the bucket-row sweeps: seven operands, the batch [P, Q, W] and three
# capacities, the R and T span masks, three scratch tensors and the output
_BUCKET_ARGS = [*[_P] * 7, *[_I] * 6, _C, _C, *[_P] * 4, _C, _P]
_LIBS = {
    "fused_linear": ("rj_fused_linear", _SWEEP_ARGS),
    "fused_star": ("rj_fused_star", _SWEEP_ARGS),
    "fused_per_r": ("rj_fused_per_r", _SWEEP_ARGS),
    "cyclic_sweep": ("rj_cyclic_sweep", _CYCLIC_ARGS),
    "pair_count": ("rj_pair_count",
                   [*[_P] * 4, _C, *[_A] * 3, *[_I] * 3, _P, _P, _C, _P]),
    "bucket_linear": ("rj_bucket_linear", _BUCKET_ARGS),
    "bucket_per_r": ("rj_bucket_per_r", _BUCKET_ARGS),
    "flash_fwd": ("rj_flash_fwd",
                  [_P, _P, _P, _P, _P, _P, _C, *[_I] * 15, _C, _C,
                   ctypes.c_float, _C, _P]),
    "flash_bwd": ("rj_flash_bwd",
                  [*[_P] * 11, _C, *[_I] * 18, _C, _C, ctypes.c_float, _C,
                   _P]),
    "radix_hist": ("rj_radix_histogram",
                   [_P, _P, _I, _C, ctypes.c_uint, _P, _C, _P]),
}

# kernel name -> launches through its wrapper (main-path evidence).  The
# fused sweeps carry the session's path; the bucket-row kernels and the
# all-pairs cyclic sweep carry the paper's baselines.
FUSED_KERNELS = ("fused_count3_linear", "fused_count3_star",
                 "fused_count3_cyclic_pairidx", "fused_per_r_counts")
BASELINE_KERNELS = ("bucket_pair_count", "bucket_count3_linear",
                    "bucket_per_r_counts", "bucket_count3_cyclic",
                    "fused_count3_cyclic")
# the attention forward (serving and training) and backward (training)
# of the LM, and the histogram of the partitioning
LM_KERNELS = ("flash_fwd", "flash_bwd")
HIST_KERNELS = ("radix_histogram",)
KERNELS = FUSED_KERNELS + BASELINE_KERNELS + LM_KERNELS + HIST_KERNELS
LAUNCHES = dict.fromkeys(KERNELS, 0)

# kernel name -> (source in the repo, TPU kernel it replaces)
SOURCES = {
    "fused_count3_linear": ("src/repro_torch/kernels/csrc/fused_linear.cu",
                            "src/repro/kernels/bucket_join.py:231"),
    "fused_count3_star": ("src/repro_torch/kernels/csrc/fused_star.cu",
                          "src/repro/kernels/bucket_join.py:425"),
    "fused_count3_cyclic_pairidx": (
        "src/repro_torch/kernels/csrc/cyclic_sweep.cu",
        "src/repro/kernels/bucket_join.py:377"),
    "fused_per_r_counts": ("src/repro_torch/kernels/csrc/fused_per_r.cu",
                           "src/repro/kernels/bucket_join.py:275"),
    "bucket_pair_count": ("src/repro_torch/kernels/csrc/pair_count.cu",
                          "src/repro/kernels/bucket_join.py:55"),
    "bucket_count3_linear": ("src/repro_torch/kernels/csrc/bucket_linear.cu",
                             "src/repro/kernels/bucket_join.py:87"),
    "bucket_per_r_counts": ("src/repro_torch/kernels/csrc/bucket_per_r.cu",
                            "src/repro/kernels/bucket_join.py:124"),
    "bucket_count3_cyclic": ("src/repro_torch/kernels/csrc/cyclic_sweep.cu",
                             "src/repro/kernels/bucket_join.py:164"),
    "fused_count3_cyclic": ("src/repro_torch/kernels/csrc/cyclic_sweep.cu",
                            "src/repro/kernels/bucket_join.py:317"),
    "flash_fwd": ("src/repro_torch/kernels/csrc/flash_fwd.cu",
                  "src/repro/kernels/flash_attention.py:110"),
    "flash_bwd": ("src/repro_torch/kernels/csrc/flash_bwd.cu",
                  "src/repro/kernels/flash_attention.py:262"),
    "radix_histogram": ("src/repro_torch/kernels/csrc/radix_hist.cu",
                        "src/repro/kernels/radix_hist.py:51"),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the Hopper "
                           "kernels are built from csrc/ at first use")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> float:
    """Compile every source that has no library yet (all in parallel) and
    load them all.  Returns the seconds spent; idempotent."""
    with _lock:
        if len(_loaded) == len(_LIBS):
            return 0.0
        t0 = time.perf_counter()
        out_dir = BUILD_ROOT / _source_hash()
        out_dir.mkdir(parents=True, exist_ok=True)
        procs = {}
        for stem in _LIBS:
            so = out_dir / f"lib{stem}.so"
            if so.exists():
                continue
            tmp = out_dir / f".lib{stem}.{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
            procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, so)
        failed = []
        for stem, (proc, tmp, so) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[stem] = log
            if proc.returncode != 0:
                failed.append(f"{stem}.cu (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for stem, (fn, argtypes) in _LIBS.items():
            lib = ctypes.CDLL(str(out_dir / f"lib{stem}.so"))
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
            lib.rj_error_string.argtypes = [ctypes.c_int]
            lib.rj_error_string.restype = ctypes.c_char_p
            _loaded[stem] = lib
        return time.perf_counter() - t0


def _lib(stem: str) -> ctypes.CDLL:
    if stem not in _loaded:
        build()
    return _loaded[stem]


def _check(op: str, dtype: torch.dtype, device: torch.device, **arrays):
    """Each argument must be a contiguous CUDA tensor on ``device`` with
    its expected shape and dtype: ``name=(tensor, shape)`` for ``dtype``
    (int64 for a name ending in "key"), ``name=(tensor, shape, dtype)``
    for another."""
    for name, (x, shape, *other) in arrays.items():
        want_dtype = (other[0] if other else
                      dtype if not name.endswith("key") else torch.int64)
        if x.device != device or x.device.type != "cuda":
            raise ValueError(f"{op}: {name} is on {x.device}, expected {device}")
        if x.dtype != want_dtype:
            raise TypeError(f"{op}: {name} has dtype {x.dtype}, expected "
                            f"{want_dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{op}: {name} has shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")


def _launch(op: str, stem: str, device: torch.device, *args) -> None:
    lib = _lib(stem)
    fn = getattr(lib, _LIBS[stem][0])
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*args, device.index if device.index is not None
            else torch.cuda.current_device(), stream)
    if rc != 0:
        msg = lib.rj_error_string(rc).decode()
        raise RuntimeError(f"{op}: CUDA launch failed: {msg} (error {rc})")
    LAUNCHES[op] += 1


def _ptr(x: torch.Tensor) -> int:
    return x.data_ptr()


def _scratch(dev: torch.device, *shapes, zero=False) -> list:
    """int32 tensors of ``shapes`` on ``dev`` (zeroed where ``zero``)."""
    make = torch.zeros if zero else torch.empty
    return [make(sh, dtype=torch.int32, device=dev) for sh in shapes]


def _linear_scratch(dev, hp, gp, u, cr, ct) -> list:
    """The linear and per-R pre-passes' scratch: (key, count) lists per H
    (keyed by (h, b), with their h) and per g, their lengths (zeroed), and
    the global tables of the lists past the shared budgets, per (H, h) and
    per g (touched only for such lists)."""
    rkc, rsub, tkc, rtab, ttab = _scratch(
        dev, (hp, u * cr, 2), (hp, u * cr), (gp, ct, 2), (hp, u, 2 * cr, 2),
        (gp, 2 * ct, 2))
    rlen, tlen = _scratch(dev, (hp,), (gp,), zero=True)
    return [rkc, rsub, rlen, tkc, tlen, rtab, ttab]


def _check_linear(op, rb, rv, sb, sc, sv, tc, tv) -> tuple:
    hp, u, cr = rb.shape
    _, gp, _, cs = sb.shape
    ct = tc.shape[1]
    b = torch.bool
    _check(op, torch.int32, rb.device, rb=(rb, (hp, u, cr)),
           rv=(rv, (hp, u, cr), b), sb=(sb, (hp, gp, u, cs)),
           sc=(sc, (hp, gp, u, cs)), sv=(sv, (hp, gp, u, cs), b),
           tc=(tc, (gp, ct)), tv=(tv, (gp, ct), b))
    return hp, gp, u, cr, cs, ct


def fused_count3_linear(rb, rv, sb, sc, sv, tc, tv) -> torch.Tensor:
    """rb [hp,u,Cr], sb/sc [hp,gp,u,Cs], tc [gp,Ct] int32 keys with their
    bool validity rv, sv, tv (not masked) -> [hp, u] int32."""
    op = "fused_count3_linear"
    hp, gp, u, cr, cs, ct = _check_linear(op, rb, rv, sb, sc, sv, tc, tv)
    dev = rb.device
    out = torch.zeros((hp, u), dtype=torch.int32, device=dev)
    _launch(op, "fused_linear", dev, *map(_ptr, (rb, rv, sb, sc, sv, tc, tv)),
            hp, gp, u, cr, cs, ct,
            *map(_ptr, (*_linear_scratch(dev, hp, gp, u, cr, ct), out)))
    return out


def fused_per_r_counts(rb, rv, sb, sc, sv, tc, tv) -> torch.Tensor:
    """Same operands as ``fused_count3_linear`` -> [hp, u, Cr] int32."""
    op = "fused_per_r_counts"
    hp, gp, u, cr, cs, ct = _check_linear(op, rb, rv, sb, sc, sv, tc, tv)
    dev = rb.device
    out = torch.empty((hp, u, cr), dtype=torch.int32, device=dev)
    _launch(op, "fused_per_r", dev, *map(_ptr, (rb, rv, sb, sc, sv, tc, tv)),
            hp, gp, u, cr, cs, ct,
            *map(_ptr, (*_linear_scratch(dev, hp, gp, u, cr, ct), out)))
    return out


def fused_count3_star(rb, rv, sb, sc, sv, tc, tv) -> torch.Tensor:
    """rb [uh,Cr], sb/sc [ch,uh,ug,Cs], tc [ug,Ct] int32 keys with their
    bool validity rv, sv, tv (not masked) -> [uh, ug] int32."""
    op = "fused_count3_star"
    uh, cr = rb.shape
    ch, _, ug, cs = sb.shape
    ct = tc.shape[1]
    dev = rb.device
    b = torch.bool
    _check(op, torch.int32, dev, rb=(rb, (uh, cr)), rv=(rv, (uh, cr), b),
           sb=(sb, (ch, uh, ug, cs)), sc=(sc, (ch, uh, ug, cs)),
           sv=(sv, (ch, uh, ug, cs), b), tc=(tc, (ug, ct)),
           tv=(tv, (ug, ct), b))
    out, rlen, tlen, tdist = _scratch(dev, (uh, ug), (uh,), (ug,), (ug,),
                                      zero=True)
    # the pre-pass's (key, count) lists per R and T row, and their global
    # tables (every R row's; T's past the sweep's shared table)
    rkc, tkc, rtab, ttab = _scratch(dev, (uh, cr, 2), (ug, ct, 2),
                                    (uh, 2 * cr, 2), (ug, 2 * ct, 2))
    _launch(op, "fused_star", dev, *map(_ptr, (rb, rv, sb, sc, sv, tc, tv)),
            ch, uh, ug, cr, cs, ct,
            *map(_ptr, (rkc, rlen, tkc, tlen, tdist, rtab, ttab, out)))
    return out


def _i64s(vals) -> ctypes.Array:
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch_cyclic(op: str, keys: tuple, dims: tuple, strides: tuple,
                   out_shape: tuple) -> torch.Tensor:
    """Launch the triangle sweep (``csrc/cyclic_sweep.cu``) for ``op`` over
    the batch ``dims`` with the row strides of R, S, T and the output per
    dimension (``strides``, 0 where a row is shared along it; the first
    dimension is the slowest the CTAs walk).  ``keys`` are the nine checked operands;
    the pre-pass's scratch is sized per distinct row, and the C code
    zeroes the lengths and the output itself (no fill kernel)."""
    ra, _, _, sb, _, _, tc, _, _ = keys
    dev = ra.device
    cr, cs, ct = ra.shape[-1], sb.shape[-1], tc.shape[-1]
    n_r, n_s, n_t = (x.shape[:-1].numel() for x in (ra, sb, tc))
    pairs = torch.empty(max(1, 2 * (n_r * cr + n_s * cs + n_t * ct)),
                        dtype=torch.int32, device=dev)
    lens = torch.empty(max(1, n_r + n_s + n_t), dtype=torch.int32,
                       device=dev)
    out = torch.empty(out_shape, dtype=torch.int32, device=dev)
    _launch(op, "cyclic_sweep", dev, *map(_ptr, keys), len(dims),
            _i64s(dims), *map(_i64s, strides), cr, cs, ct, _ptr(pairs),
            _ptr(lens), _ptr(out))
    return out


def _fused_cyclic(op: str, ra, rb, rv, sb, sc, sv, tc, ta,
                  tv) -> torch.Tensor:
    """The fused triangle grid: R cells (i, j, a, b), S rows (j, f, b), T
    rows (i, f, a), walked as the batch (f, i, j, a, b): one CTA per T row
    (f, i, a), f slowest, over the cells (j, b); the output ignores f."""
    hp, gp, uh, ug, cr = ra.shape
    _, fp, _, cs = sb.shape
    ct = tc.shape[-1]
    b = torch.bool
    r, s, t = (hp, gp, uh, ug, cr), (gp, fp, ug, cs), (hp, fp, uh, ct)
    _check(op, torch.int32, ra.device, ra=(ra, r), rb=(rb, r), rv=(rv, r, b),
           sb=(sb, s), sc=(sc, s), sv=(sv, s, b), tc=(tc, t), ta=(ta, t),
           tv=(tv, t, b))
    cells = (0, gp * uh * ug, uh * ug, ug, 1)
    return _launch_cyclic(
        op, (ra, rb, rv, sb, sc, sv, tc, ta, tv), (fp, hp, gp, uh, ug),
        (cells, (ug, 0, fp * ug, 0, 1), (uh, fp * uh, 0, 1, 0), cells),
        (hp, gp, uh, ug))


def fused_count3_cyclic_pairidx(ra, rb, rv, sb, sc, sv, tc, ta,
                                tv) -> torch.Tensor:
    """ra/rb [hp,gp,uh,ug,Cr], sb/sc [gp,fp,ug,Cs], tc/ta [hp,fp,uh,Ct]
    int32 keys with their bool validity rv, sv, tv (not masked) ->
    [hp,gp,uh,ug] int32."""
    return _fused_cyclic("fused_count3_cyclic_pairidx", ra, rb, rv, sb, sc,
                         sv, tc, ta, tv)


def fused_count3_cyclic(ra, rb, rv, sb, sc, sv, tc, ta, tv) -> torch.Tensor:
    """The all-pairs form of the triangle sweep, on the pair-index sweep's
    tables: same operands, counts and kernel as
    ``fused_count3_cyclic_pairidx``, its own launch counter."""
    return _fused_cyclic("fused_count3_cyclic", ra, rb, rv, sb, sc, sv, tc,
                         ta, tv)


# --------------------------------------------------------------------------
# the bucket-row kernels of the baselines
# --------------------------------------------------------------------------

def _padded_batch(op: str, nd: int, *rows) -> tuple[tuple, tuple]:
    """The common batch shape of bucket-row operands ``[*batch, C]``, as it
    is and left-padded with 1s to ``nd`` dimensions."""
    batch = tuple(torch.broadcast_shapes(*(x.shape[:-1] for x in rows)))
    if len(batch) > nd:
        raise ValueError(f"{op}: at most {nd} batch dimensions, got "
                         f"{batch}")
    return batch, (1,) * (nd - len(batch)) + batch


def _shape_nd(x: torch.Tensor, nd: int) -> tuple:
    return (1,) * (nd - (x.dim() - 1)) + tuple(x.shape[:-1])


def _span_mask(x: torch.Tensor, nd: int) -> int:
    """Bit d set iff ``x`` spans batch dimension d (elsewhere it has size
    1: one row shared along that dimension)."""
    return sum(1 << d for d, n in enumerate(_shape_nd(x, nd)) if n != 1)


def _row_strides(shp: tuple) -> list:
    """Row stride of contiguous rows of batch shape ``shp`` per batch
    dimension, 0 along a dimension of size 1."""
    nd = len(shp)
    out, step = [0] * nd, 1
    for d in range(nd - 1, -1, -1):
        if shp[d] != 1:
            out[d] = step
            step *= shp[d]
    return out


def bucket_pair_count(ka, va, kb, vb) -> torch.Tensor:
    """ka [*batch, Ca], kb [*batch, Cb] int32 keys with their bool validity
    va, vb of the same shapes (not masked; at most five batch dimensions;
    size-1 dimensions share one row, read through a zero row stride) ->
    [*batch] int32.  The side with the shorter rows (a on a tie) is
    listed, one (key, count) list per distinct row; the other side's rows
    are streamed against the lists (``csrc/pair_count.cu``)."""
    op = "bucket_pair_count"
    batch, dims = _padded_batch(op, 5, ka, kb)
    b = torch.bool
    _check(op, torch.int32, ka.device, ka=(ka, ka.shape),
           va=(va, ka.shape, b), kb=(kb, kb.shape), vb=(vb, kb.shape, b))
    (lk, lv), (sk, sv) = (((kb, vb), (ka, va))
                          if kb.shape[-1] < ka.shape[-1]
                          else ((ka, va), (kb, vb)))
    cl, cs = lk.shape[-1], sk.shape[-1]
    n_l = lk.shape[:-1].numel()
    # the lengths and distinct counts, the (key, count) lists and their
    # global tables, per listed row (zeroed where needed by the C code)
    scratch = torch.empty(2 * n_l + 6 * n_l * cl, dtype=torch.int32,
                          device=ka.device)
    out = torch.empty(batch, dtype=torch.int32, device=ka.device)
    _launch(op, "pair_count", ka.device, _ptr(lk), _ptr(lv), _ptr(sk),
            _ptr(sv), len(dims), _i64s(dims),
            *(_i64s(_row_strides(_shape_nd(x, 5))) for x in (lk, sk)), cl,
            cs, n_l, _ptr(scratch), _ptr(out))
    return out


def _launch_bucket_sweep(op: str, stem: str, rb, rv, sb, sc, sv, tc, tv,
                         per_r: bool) -> torch.Tensor:
    """Shared set-up of the bucket-row linear and per-R sweeps: the batch
    padded to three dimensions [P, Q, W], S spanning all of it, R and T
    rows with their span masks, and the pre-pass's scratch sized per
    distinct R and T row."""
    batch, dims = _padded_batch(op, 3, rb, sb, sc, tc)
    cr, cs, ct = rb.shape[-1], sb.shape[-1], tc.shape[-1]
    b = torch.bool
    dev = rb.device
    _check(op, torch.int32, dev, rb=(rb, rb.shape), rv=(rv, rb.shape, b),
           sb=(sb, (*batch, cs)), sc=(sc, (*batch, cs)),
           sv=(sv, (*batch, cs), b), tc=(tc, tc.shape),
           tv=(tv, tc.shape, b))
    n_r, n_t = rb.shape[:-1].numel(), tc.shape[:-1].numel()
    # rlen, tlen, tdist; the (key, count) lists; their global tables (the
    # kernel zeroes the lengths and a count output itself: no fill kernel)
    lens = torch.empty(n_r + 2 * n_t, dtype=torch.int32, device=dev)
    lists = torch.empty(max(1, 2 * (n_r * cr + n_t * ct)), dtype=torch.int32,
                        device=dev)
    tabs = torch.empty(max(1, 4 * (n_r * cr + n_t * ct)), dtype=torch.int32,
                       device=dev)
    out = torch.empty((*batch, cr) if per_r else batch, dtype=torch.int32,
                      device=dev)
    _launch(op, stem, dev, *map(_ptr, (rb, rv, sb, sc, sv, tc, tv)), *dims,
            cr, cs, ct, _span_mask(rb, 3), _span_mask(tc, 3), _ptr(lens),
            _ptr(lists), _ptr(tabs), _ptr(out))
    return out


def bucket_count3_linear(rb, rv, sb, sc, sv, tc, tv) -> torch.Tensor:
    """rb [*batch, Cr], sb/sc [*batch, Cs], tc [*batch, Ct] int32 keys with
    their bool validity rv, sv, tv of the same shapes (not masked; at most
    three batch dimensions, S spanning all of them) -> [*batch] int32."""
    return _launch_bucket_sweep("bucket_count3_linear", "bucket_linear", rb,
                                rv, sb, sc, sv, tc, tv, per_r=False)


def bucket_per_r_counts(rb, rv, sb, sc, sv, tc, tv) -> torch.Tensor:
    """Same operands as ``bucket_count3_linear`` -> [*batch, Cr] int32 (0
    for a dead R slot).  Nothing is allocated beside the output but the
    pre-pass's lists and tables."""
    return _launch_bucket_sweep("bucket_per_r_counts", "bucket_per_r", rb,
                                rv, sb, sc, sv, tc, tv, per_r=True)


def bucket_count3_cyclic(ra, rb, rv, sb, sc, sv, tc, ta,
                         tv) -> torch.Tensor:
    """ra/rb [*batch, Cr], sb/sc [*batch, Cs], tc/ta [*batch, Ct] int32
    keys with their bool validity rv, sv, tv of the same shapes (not
    masked; at most five batch dimensions; size-1 dimensions share one
    row) -> [*batch] int32.  One CTA per distinct T row (or split of its
    buckets) walks the buckets it serves."""
    op = "bucket_count3_cyclic"
    batch, dims = _padded_batch(op, 5, ra, sb, tc)
    b = torch.bool
    _check(op, torch.int32, ra.device, ra=(ra, ra.shape), rb=(rb, ra.shape),
           rv=(rv, ra.shape, b), sb=(sb, sb.shape), sc=(sc, sb.shape),
           sv=(sv, sb.shape, b), tc=(tc, tc.shape), ta=(ta, tc.shape),
           tv=(tv, tc.shape, b))
    return _launch_cyclic(
        op, (ra, rb, rv, sb, sc, sv, tc, ta, tv), dims,
        (*(_row_strides(_shape_nd(x, 5)) for x in (ra, sb, tc)),
         _row_strides(dims)), batch)


# --------------------------------------------------------------------------
# the flash attention forward and backward, and the radix histogram
# --------------------------------------------------------------------------

_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_flash(op: str, q, **rows) -> None:
    """q and each of ``rows`` in q's dtype (f32 or bf16) on q's CUDA
    device, with unit stride along D and rows aligned to 16 bytes (4 f32
    or 8 bf16 elements: the bf16 kernels read them with TMA); D a multiple
    of 8 up to 256."""
    dev, d = q.device, q.shape[3]
    if q.dtype not in _FLASH_DTYPES:
        raise TypeError(f"{op}: dtype {q.dtype}; the kernel takes "
                        f"{sorted(map(str, _FLASH_DTYPES))}")
    if d % 8 or not 0 < d <= 256:
        raise ValueError(f"{op}: head dim {d} is not a multiple of 8 in "
                         "[8, 256]")
    named = (("q", q), *rows.items())
    for name, x in named:
        if x.dtype != q.dtype:
            raise TypeError(f"{op}: {name} has dtype {x.dtype}, expected "
                            f"{q.dtype}")
        size = x.element_size()
        strides = [st for st, n in zip(x.stride()[:3], x.shape[:3]) if n > 1]
        if (x.stride(3) != 1 or any(st * size % 16 for st in strides)
                or x.data_ptr() % 16):
            raise ValueError(f"{op}: {name} needs unit stride along D and "
                             f"rows aligned to 16 bytes ({16 // size} "
                             "elements)")
    for name, x in named:
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{op}: {name} is on {x.device}, expected "
                             f"{dev}")


def flash_fwd(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,S,H,D], k/v [B,T,KVH,D] (f32 or bf16, unit stride along D, any
    other strides that keep rows 16-byte aligned) -> (o [B,S,H,D] in q's
    dtype, m [B,H,S,1] f32, l [B,H,S,1] f32)."""
    op = "flash_fwd"
    dev = q.device
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    _check_flash(op, q, k=k, v=v)
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    m = torch.empty((b, h, s, 1), dtype=torch.float32, device=dev)
    l = torch.empty((b, h, s, 1), dtype=torch.float32, device=dev)
    _launch(op, "flash_fwd", dev, _ptr(q), _ptr(k), _ptr(v), _ptr(o),
            _ptr(m), _ptr(l), _FLASH_DTYPES[q.dtype], b, s, t, h, kvh, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
            int(window), 1.0 / d ** 0.5)
    return o, m, l


def flash_bwd(q, k, v, o, m, l, do, *, causal: bool = True,
              window: int = 0):
    """q, do [B,S,H,D], k/v [B,T,KVH,D] (f32 or bf16, read through their
    strides as ``flash_fwd`` reads q, k, v), o [B,S,H,D] and the forward's
    m, l [B,H,S,1] f32 -> (dq [B,S,H,D], dk, dv [B,T,KVH,D]) in the input
    dtype, contiguous.  ``delta = sum_D o do`` is a torch reduction.  In
    bf16 with H > KVH the dkv kernel writes f32 per-query-head partials
    of dk and dv to a scratch ``[2, B, T, H, D]`` that a second kernel sums
    per kv head."""
    op = "flash_bwd"
    dev = q.device
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    _check_flash(op, q, k=k, v=v, do=do)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"{op}: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    m, l = m.reshape(b, h, s), l.reshape(b, h, s)
    _check(op, torch.float32, dev, m=(m, (b, h, s)), l=(l, (b, h, s)))
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, t, kvh, d), dtype=q.dtype, device=dev)
    dv = torch.empty((b, t, kvh, d), dtype=q.dtype, device=dev)
    part = None
    if q.dtype == torch.bfloat16 and h > kvh:
        part = torch.empty((2, b, t, h, d), dtype=torch.float32, device=dev)
    _launch(op, "flash_bwd", dev, _ptr(q), _ptr(k), _ptr(v), _ptr(do),
            _ptr(m), _ptr(l), _ptr(delta), _ptr(dq), _ptr(dk), _ptr(dv),
            None if part is None else _ptr(part), _FLASH_DTYPES[q.dtype], b,
            s, t, h, kvh, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *do.stride()[:3], int(causal), int(window),
            1.0 / d ** 0.5)
    return dq, dk, dv


def radix_histogram(keys, valid, *, n_buckets: int) -> torch.Tensor:
    """keys (n,) int32, valid (n,) bool -> (n_buckets,) int32: the live keys
    per bucket of ``hash_bucket(keys, n_buckets, "H")``."""
    op = "radix_histogram"
    dev = keys.device
    n = keys.shape[0]
    _check(op, torch.int32, dev, keys=(keys, (n,)),
           valid=(valid, (n,), torch.bool))
    if not 0 < n_buckets < 2**31:
        raise ValueError(f"{op}: n_buckets {n_buckets} out of range")
    out = torch.empty((n_buckets,), dtype=torch.int32, device=dev)
    _launch(op, "radix_hist", dev, _ptr(keys), _ptr(valid), n, n_buckets,
            _SEEDS["H"], _ptr(out))
    return out
