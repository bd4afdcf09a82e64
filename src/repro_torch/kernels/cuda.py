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

The operands arrive sentinel-masked (``ops._mask``), so a slot holding its
side's sentinel is dead and equals no key.  The wrappers sort each bucket
row that the kernels binary-search (R and T rows; the cyclic sweep's
packed (b, a) and (c, a) keys), and hand the cyclic kernel each S bucket's
live length (one past its last live slot), so it skips dead tails.
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

from repro_torch.kernels.ops import _SENT, sorted_pair_keys

_HERE = pathlib.Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_ROOT = _HERE / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_longlong
_C = ctypes.c_int

# source stem -> (exported function, argtypes).  Pointer and stream
# arguments are c_void_p and sizes c_longlong, so ctypes passes no pointer
# as a 32-bit int.
_SWEEP_ARGS = [_P, _P, _P, _P, _C, _I, _I, _I, _I, _I, _I, _P, _C, _P]
_LIBS = {
    "fused_linear": ("rj_fused_linear", _SWEEP_ARGS),
    "fused_star": ("rj_fused_star", _SWEEP_ARGS),
    "fused_per_r": ("rj_fused_per_r",
                    [_P, _P, _P, _P, _P, _C, _I, _I, _I, _I, _I, _I, _P, _P,
                     _C, _P]),
    "fused_cyclic_pairidx": ("rj_fused_cyclic_pairidx",
                             [_P, _P, _P, _P, _P, _C, _I, _I, _I, _I, _I, _I,
                              _I, _I, _P, _C, _P]),
}

# kernel name -> launches through its wrapper (main-path evidence)
KERNELS = ("fused_count3_linear", "fused_count3_star",
           "fused_count3_cyclic_pairidx", "fused_per_r_counts")
LAUNCHES = dict.fromkeys(KERNELS, 0)

# kernel name -> (source in the repo, TPU kernel it replaces)
SOURCES = {
    "fused_count3_linear": ("src/repro_torch/kernels/csrc/fused_linear.cu",
                            "src/repro/kernels/bucket_join.py:231"),
    "fused_count3_star": ("src/repro_torch/kernels/csrc/fused_star.cu",
                          "src/repro/kernels/bucket_join.py:425"),
    "fused_count3_cyclic_pairidx": (
        "src/repro_torch/kernels/csrc/fused_cyclic_pairidx.cu",
        "src/repro/kernels/bucket_join.py:377"),
    "fused_per_r_counts": ("src/repro_torch/kernels/csrc/fused_per_r.cu",
                           "src/repro/kernels/bucket_join.py:275"),
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
    """Each argument must be a contiguous CUDA tensor of ``dtype`` on
    ``device`` with its expected shape: ``name=(tensor, shape)``."""
    for name, (x, shape) in arrays.items():
        want_dtype = dtype if name != "tkey" else torch.int64
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


def _live_len(rows: torch.Tensor, side: str) -> torch.Tensor:
    """One past the last slot of each bucket row that does not hold the
    side's sentinel (0 for an all-dead row): int32 [n_rows]."""
    c = rows.shape[-1]
    rows = rows.reshape(-1, c)
    pos = torch.arange(1, c + 1, dtype=torch.int32, device=rows.device)
    live = torch.where(rows != _SENT[side], pos, torch.zeros_like(pos))
    return live.amax(dim=1).to(torch.int32).contiguous()


def _sorted_rows(x: torch.Tensor) -> torch.Tensor:
    """Each bucket row (the last dimension) sorted ascending, contiguous."""
    return torch.sort(x, dim=-1).values.contiguous()


def fused_count3_linear(rb, sb, sc, tc) -> torch.Tensor:
    """rb [hp,u,Cr], sb/sc [hp,gp,u,Cs], tc [gp,Ct] int32 (sentinel-masked)
    -> [hp, u] int32."""
    hp, u, cr = rb.shape
    _, gp, _, cs = sb.shape
    ct = tc.shape[1]
    dev = rb.device
    _check("fused_count3_linear", torch.int32, dev, rb=(rb, (hp, u, cr)),
           sb=(sb, (hp, gp, u, cs)), sc=(sc, (hp, gp, u, cs)),
           tc=(tc, (gp, ct)))
    out = torch.zeros((hp, u), dtype=torch.int32, device=dev)
    r_sorted, t_sorted = _sorted_rows(rb), _sorted_rows(tc)
    _launch("fused_count3_linear", "fused_linear", dev, _ptr(r_sorted),
            _ptr(sb), _ptr(sc), _ptr(t_sorted), _SENT["s"], hp, gp, u, cr,
            cs, ct, _ptr(out))
    return out


def fused_per_r_counts(rb, sb, sc, tc) -> torch.Tensor:
    """rb [hp,u,Cr], sb/sc [hp,gp,u,Cs], tc [gp,Ct] int32 (sentinel-masked)
    -> [hp, u, Cr] int32."""
    hp, u, cr = rb.shape
    _, gp, _, cs = sb.shape
    ct = tc.shape[1]
    dev = rb.device
    _check("fused_per_r_counts", torch.int32, dev, rb=(rb, (hp, u, cr)),
           sb=(sb, (hp, gp, u, cs)), sc=(sc, (hp, gp, u, cs)),
           tc=(tc, (gp, ct)))
    out = torch.empty((hp, u, cr), dtype=torch.int32, device=dev)
    acc = torch.zeros((hp, u, cr), dtype=torch.int32, device=dev)
    r_sorted, t_sorted = _sorted_rows(rb), _sorted_rows(tc)
    _launch("fused_per_r_counts", "fused_per_r", dev, _ptr(rb),
            _ptr(r_sorted), _ptr(sb), _ptr(sc), _ptr(t_sorted), _SENT["s"],
            hp, gp, u, cr, cs, ct, _ptr(acc), _ptr(out))
    return out


def fused_count3_star(rb, sb, sc, tc) -> torch.Tensor:
    """rb [uh,Cr], sb/sc [ch,uh,ug,Cs], tc [ug,Ct] int32 (sentinel-masked)
    -> [uh, ug] int32."""
    uh, cr = rb.shape
    ch, _, ug, cs = sb.shape
    ct = tc.shape[1]
    dev = rb.device
    _check("fused_count3_star", torch.int32, dev, rb=(rb, (uh, cr)),
           sb=(sb, (ch, uh, ug, cs)), sc=(sc, (ch, uh, ug, cs)),
           tc=(tc, (ug, ct)))
    out = torch.zeros((uh, ug), dtype=torch.int32, device=dev)
    r_sorted, t_sorted = _sorted_rows(rb), _sorted_rows(tc)
    _launch("fused_count3_star", "fused_star", dev, _ptr(r_sorted), _ptr(sb),
            _ptr(sc), _ptr(t_sorted), _SENT["s"], ch, uh, ug, cr, cs, ct,
            _ptr(out))
    return out


def fused_count3_cyclic_pairidx(ra, rb, sb, sc, tkey) -> torch.Tensor:
    """ra/rb [hp,gp,uh,ug,Cr], sb/sc [gp,fp,ug,Cs] int32 (sentinel-masked),
    tkey [hp,fp,uh,Ct] int64 sorted (c, a) pair keys -> [hp,gp,uh,ug]
    int32."""
    hp, gp, uh, ug, cr = ra.shape
    _, fp, _, cs = sb.shape
    ct = tkey.shape[-1]
    dev = ra.device
    _check("fused_count3_cyclic_pairidx", torch.int32, dev,
           ra=(ra, (hp, gp, uh, ug, cr)), rb=(rb, (hp, gp, uh, ug, cr)),
           sb=(sb, (gp, fp, ug, cs)), sc=(sc, (gp, fp, ug, cs)),
           tkey=(tkey, (hp, fp, uh, ct)))
    out = torch.zeros((hp, gp, uh, ug), dtype=torch.int32, device=dev)
    rkey = sorted_pair_keys(rb, ra).contiguous()   # each R cell by (b, a)
    s_len = _live_len(sb, "s")
    _launch("fused_count3_cyclic_pairidx", "fused_cyclic_pairidx", dev,
            _ptr(rkey), _ptr(sb), _ptr(sc), _ptr(tkey), _ptr(s_len),
            _SENT["s"], hp, gp, uh, ug, fp, cr, cs, ct, _ptr(out))
    return out
