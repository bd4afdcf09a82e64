"""The Hopper kernels against their plain versions, on the card.

Every test here needs a CUDA device (the kernels have no CPU mode) and
skips without one.  The file imports neither JAX nor the JAX package, so
it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Counts are integers: the tolerance is exact equality.  The flash forward
is held to ``chip_smoke.FLASH_TOL`` (o) and ``STATS_RTOL`` (m, l), the
flash backward to ``chip_smoke.FLASH_BWD_TOL`` (dq, dk, dv).
"""

import importlib.util
import pathlib

import pytest
import torch

from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _smoke():
    """``chip_smoke.py`` at the repo root: it holds the one table of seeded
    kernel layouts (unaligned capacities, invalid slots, hot keys)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 1])
def test_kernels_match_plain_versions(card, seed):
    smoke = _smoke()
    for name, kern, plain in smoke.kernel_cases(torch, ops, seed):
        err, ok = smoke.case_error(torch, name, kern(), plain())
        assert ok, (name, err)


def test_all_pairs_cyclic_launches_its_kernel_on_cuda(card):
    from repro_torch.kernels import cuda
    gen = torch.Generator().manual_seed(7)

    def grid(shape):
        keys = torch.randint(0, 5, shape, generator=gen, dtype=torch.int32)
        return keys.to(card), (torch.rand(shape, generator=gen) < 0.8).to(card)

    ra, rv = grid((2, 2, 2, 3, 41))
    rb, _ = grid((2, 2, 2, 3, 41))
    sb, sv = grid((2, 3, 3, 29))
    sc, _ = grid((2, 3, 3, 29))
    tc, tv = grid((2, 3, 2, 37))
    ta, _ = grid((2, 3, 2, 37))
    before = dict(cuda.LAUNCHES)
    got = ops.fused_count3_cyclic(ra, rb, rv, sb, sc, sv, tc, ta, tv,
                                  pair_index=False)
    assert cuda.LAUNCHES["fused_count3_cyclic"] == \
        before["fused_count3_cyclic"] + 1
    assert cuda.LAUNCHES["fused_count3_cyclic_pairidx"] == \
        before["fused_count3_cyclic_pairidx"]
    m = [ops._mask(x, v, side) for x, v, side in
         ((ra, rv, "r"), (rb, rv, "r"), (sb, sv, "s"), (sc, sv, "s"),
          (tc, tv, "t"), (ta, tv, "t"))]
    assert torch.equal(got, ops._fused_cyclic_pairidx_ref(*m))


def test_wrappers_check_their_inputs(card):
    from repro_torch.kernels import cuda
    rb = torch.zeros((1, 2, 8), dtype=torch.int32, device=card)
    sb = torch.zeros((1, 1, 2, 8), dtype=torch.int32, device=card)
    tc = torch.zeros((1, 8), dtype=torch.int32, device=card)
    rv, sv, tv = rb != 0, sb != 0, tc != 0
    with pytest.raises(TypeError, match="dtype"):
        cuda.fused_count3_linear(rb.long(), rv, sb, sb, sv, tc, tv)
    with pytest.raises(TypeError, match="dtype"):
        cuda.fused_count3_linear(rb, rb, sb, sb, sv, tc, tv)
    with pytest.raises(ValueError, match="shape"):
        cuda.fused_count3_linear(rb, rv, sb, sb[..., :4].contiguous(), sv,
                                 tc, tv)
    with pytest.raises(ValueError, match="contiguous"):
        cuda.fused_count3_linear(rb, rv, sb, sb.transpose(2, 3).contiguous()
                                 .transpose(2, 3), sv, tc, tv)
    with pytest.raises(ValueError, match="cpu"):
        cuda.fused_count3_linear(rb, rv, sb, sb, sv, tc.cpu(), tv)
    # the per-R sweep takes the linear sweep's operands
    with pytest.raises(TypeError, match="dtype"):
        cuda.fused_per_r_counts(rb, rv, sb, sb, sv.int(), tc, tv)
    with pytest.raises(ValueError, match="shape"):
        cuda.fused_per_r_counts(rb, rv[..., :4].contiguous(), sb, sb, sv, tc,
                                tv)
    with pytest.raises(ValueError, match="contiguous"):
        cuda.fused_per_r_counts(rb.transpose(1, 2).contiguous()
                                .transpose(1, 2), rv, sb, sb, sv, tc, tv)
    with pytest.raises(ValueError, match="cpu"):
        cuda.fused_per_r_counts(rb, rv, sb, sb, sv, tc, tv.cpu())
    # star: R [uh, Cr], S [chunks, uh, ug, Cs], T [ug, Ct]
    sr = torch.zeros((2, 8), dtype=torch.int32, device=card)
    ss = torch.zeros((1, 2, 3, 8), dtype=torch.int32, device=card)
    st = torch.zeros((3, 8), dtype=torch.int32, device=card)
    srv, ssv, stv = sr != 0, ss != 0, st != 0
    with pytest.raises(TypeError, match="dtype"):
        cuda.fused_count3_star(sr, srv, ss, ss.long(), ssv, st, stv)
    with pytest.raises(TypeError, match="dtype"):
        cuda.fused_count3_star(sr, srv, ss, ss, ssv, st, st)
    with pytest.raises(ValueError, match="shape"):
        cuda.fused_count3_star(sr, srv, ss, ss, ssv, st[:2].contiguous(),
                               stv)
    with pytest.raises(ValueError, match="contiguous"):
        cuda.fused_count3_star(sr, srv, ss, ss, ssv.transpose(2, 3)
                               .contiguous().transpose(2, 3), st, stv)
    with pytest.raises(ValueError, match="cpu"):
        cuda.fused_count3_star(sr.cpu(), srv, ss, ss, ssv, st, stv)
    r = torch.zeros((1, 1, 1, 1, 8), dtype=torch.int32, device=card)
    s = torch.zeros((1, 1, 1, 8), dtype=torch.int32, device=card)
    t = torch.zeros((1, 1, 1, 8), dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="dtype"):
        cuda.fused_count3_cyclic_pairidx(r, r, r, s, s, s != 0, t, t, t != 0)
    with pytest.raises(ValueError, match="shape"):
        cuda.fused_count3_cyclic_pairidx(r, r, r != 0, s, s, s != 0, t,
                                         t[..., :4].contiguous(), t != 0)


def test_bucket_wrappers_check_their_inputs(card):
    """The bucket-row linear and per-R wrappers take raw keys and bool
    validity of the keys' shapes, contiguous, on the card, with S
    spanning the whole batch."""
    from repro_torch.kernels import cuda
    rb = torch.zeros((1, 4, 8), dtype=torch.int32, device=card)
    sb = torch.zeros((3, 4, 5), dtype=torch.int32, device=card)
    tc = torch.zeros((3, 1, 9), dtype=torch.int32, device=card)
    rv, sv, tv = rb != 0, sb != 0, tc != 0
    for fn in (cuda.bucket_count3_linear, cuda.bucket_per_r_counts):
        with pytest.raises(TypeError, match="dtype"):
            fn(rb, rv.int(), sb, sb, sv, tc, tv)
        with pytest.raises(TypeError, match="dtype"):
            fn(rb, rv, sb.long(), sb, sv, tc, tv)
        with pytest.raises(ValueError, match="shape"):
            fn(rb, rv, sb, sb, sv, tc, tv[..., :4].contiguous())
        with pytest.raises(ValueError, match="shape"):   # S shared along g
            fn(rb, rv, sb[:1].contiguous(), sb[:1].contiguous(),
               sv[:1].contiguous(), tc, tv)
        with pytest.raises(ValueError, match="contiguous"):
            fn(rb, rv, sb, sb.transpose(1, 2).contiguous().transpose(1, 2),
               sv, tc, tv)
        with pytest.raises(ValueError, match="cpu"):
            fn(rb, rv, sb, sb, sv, tc.cpu(), tv)


def _kernels_by_name(smoke, fn):
    """The device ms by kernel name of ``fn``'s launches
    (``chip_smoke.kernel_ms``, which takes the trace again, up to 3 times,
    where it came back without its device events)."""
    _, by_name, missing = smoke.kernel_ms(torch, fn)
    if missing is not None:
        raise AssertionError(missing)
    return by_name


def _bucket_rows(gen, shape, d, live, card):
    """Keys of [0, d) and validity whose live slots fill the front of each
    row (``live`` of them), as a bucketized layout holds them."""
    keys = torch.randint(0, d, shape, generator=gen, dtype=torch.int32)
    valid = torch.arange(shape[-1]).expand(shape) < live
    return keys.to(card), valid.contiguous().to(card)


# the linear scans' rows at a B1-like first step (T rows 10% live, ~57
# distinct keys a row, R rows of ~1 key) and the star scan's at a
# B2-like chunk (cells long enough to be split, R and T rows past the
# shared tables)
@pytest.mark.parametrize("layout", ["linear", "star"])
def test_bucket_sweeps_launch_their_kernels_on_cuda(card, layout):
    from repro_torch.kernels import cuda
    gen = torch.Generator().manual_seed(9)
    if layout == "linear":
        gp, u, cr, cs, ct = 40, 64, 2560, 32, 20_000
        rb, rv = _bucket_rows(gen, (1, u, cr), 2, 250, card)
        sb, sv = _bucket_rows(gen, (gp, u, cs), 60, 16, card)
        sc, _ = _bucket_rows(gen, (gp, u, cs), 60, 16, card)
        tc, tv = _bucket_rows(gen, (gp, 1, ct), 60, 2000, card)
    else:
        uh, ug, cr, cs, ct = 4, 4, 12_000, 60_000, 12_000
        rb, rv = _bucket_rows(gen, (uh, 1, cr), 100_000, 10_000, card)
        sb, sv = _bucket_rows(gen, (uh, ug, cs), 100_000, 50_000, card)
        sc, _ = _bucket_rows(gen, (uh, ug, cs), 100_000, 50_000, card)
        tc, tv = _bucket_rows(gen, (1, ug, ct), 100_000, 10_000, card)
    args = (rb, rv, sb, sc, sv, tc, tv)
    m = [ops._mask(x, v, side) for x, v, side in
         ((rb, rv, "r"), (sb, sv, "s"), (sc, sv, "s"), (tc, tv, "t"))]
    before = dict(cuda.LAUNCHES)
    got = ops.bucket_count3_linear(*args)
    got_r = ops.bucket_per_r_counts(*args)
    for name in ("bucket_count3_linear", "bucket_per_r_counts"):
        assert cuda.LAUNCHES[name] == before[name] + 1
    assert torch.equal(got, ops._bucket_linear_ref(*m))
    assert torch.equal(got_r, ops._bucket_per_r_ref(*m))
    assert int(got.to(torch.int64).sum()) > 0


# B4's layouts (1e5 edges over 350 users, final plan [2, 4, 8, 8, 4, 496,
# 1960, 3912]): the scan's first (H, G) cell, R [8, 8] shared along f, S
# [4, 1, 8] along a and T [4, 8, 1] along b, and the fused grid
@pytest.mark.parametrize("form", ["bucket", "fused"])
def test_cyclic_ops_launch_only_their_sweep_on_cuda(card, form):
    """Each all-pairs triangle op launches its own kernel, counted on its
    own counter, and no sort or elementwise kernel: the pre-pass packs the
    raw keys with their validity, the lengths and the output are zeroed by
    memsets."""
    from repro_torch.kernels import cuda
    smoke = _smoke()
    gen = torch.Generator().manual_seed(13)
    hp, gp, uh, ug, fp, cr, cs, ct = 2, 4, 8, 8, 4, 496, 1960, 3912

    def rows(shape, live):
        k = [_bucket_rows(gen, shape, 350, live, card)[0] for _ in range(2)]
        return (*k, _bucket_rows(gen, shape, 350, live, card)[1])
    if form == "bucket":
        name, r, s, t = ("bucket_count3_cyclic", (uh, ug, cr),
                         (fp, 1, ug, cs), (fp, uh, 1, ct))
        op, plain = ops.bucket_count3_cyclic, ops._bucket_cyclic_ref
    else:
        name, r, s, t = ("fused_count3_cyclic", (hp, gp, uh, ug, cr),
                         (gp, fp, ug, cs), (hp, fp, uh, ct))
        op, plain = ops.fused_count3_cyclic, ops._fused_cyclic_pairidx_ref
    ra, rb, rv = rows(r, 200)
    sb, sc, sv = rows(s, 780)
    tc, ta, tv = rows(t, 1560)
    args = (ra, rb, rv, sb, sc, sv, tc, ta, tv)
    kw = {} if form == "bucket" else {"pair_index": False}
    before = dict(cuda.LAUNCHES)
    got = op(*args, **kw)
    assert {k: cuda.LAUNCHES[k] - before[k] for k in cuda.KERNELS
            if cuda.LAUNCHES[k] != before[k]} == {name: 1}
    m = [ops._mask(x, v, side) for x, v, side in
         ((ra, rv, "r"), (rb, rv, "r"), (sb, sv, "s"), (sc, sv, "s"),
          (tc, tv, "t"), (ta, tv, "t"))]
    assert torch.equal(got, plain(*m))
    assert int(got.to(torch.int64).sum()) > 0
    by_name = _kernels_by_name(smoke, lambda: op(*args, **kw))
    assert smoke.sorts_and_masks(by_name) == [], by_name
    assert any("cyclic_sweep_kernel" in k for k in by_name), by_name


def test_cyclic_wrappers_check_their_inputs(card):
    """The bucket-row and all-pairs triangle wrappers take raw keys and
    bool validity of the keys' shapes, contiguous, on the card."""
    from repro_torch.kernels import cuda
    r = torch.zeros((3, 2, 8), dtype=torch.int32, device=card)
    s = torch.zeros((4, 1, 2, 8), dtype=torch.int32, device=card)
    t = torch.zeros((4, 3, 1, 8), dtype=torch.int32, device=card)
    rv, sv, tv = r != 0, s != 0, t != 0
    fn = cuda.bucket_count3_cyclic
    assert fn(r, r, rv, s, s, sv, t, t, tv).shape == (4, 3, 2)
    with pytest.raises(TypeError, match="dtype"):
        fn(r, r, rv.int(), s, s, sv, t, t, tv)
    with pytest.raises(TypeError, match="dtype"):
        fn(r, r, rv, s.long(), s, sv, t, t, tv)
    with pytest.raises(ValueError, match="shape"):
        fn(r, r, rv, s, s, sv, t, t[..., :4].contiguous(), tv)
    with pytest.raises(RuntimeError):   # batches that do not broadcast
        fn(r, r, rv, s, s, sv, t[:2].contiguous(), t[:2].contiguous(),
           tv[:2].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fn(r.transpose(1, 2).contiguous().transpose(1, 2), r, rv, s, s, sv,
           t, t, tv)
    with pytest.raises(ValueError, match="cpu"):
        fn(r, r, rv, s, s, sv.cpu(), t, t, tv)
    fr = torch.zeros((1, 2, 2, 3, 8), dtype=torch.int32, device=card)
    fs = torch.zeros((2, 4, 3, 8), dtype=torch.int32, device=card)
    ft = torch.zeros((1, 4, 2, 8), dtype=torch.int32, device=card)
    frv, fsv, ftv = fr != 0, fs != 0, ft != 0
    fn = cuda.fused_count3_cyclic
    assert fn(fr, fr, frv, fs, fs, fsv, ft, ft, ftv).shape == (1, 2, 2, 3)
    with pytest.raises(TypeError, match="dtype"):
        fn(fr, fr, frv, fs, fs, fsv, ft, ft, ft)
    with pytest.raises(TypeError, match="dtype"):
        fn(fr, fr.long(), frv, fs, fs, fsv, ft, ft, ftv)
    with pytest.raises(ValueError, match="shape"):
        fn(fr, fr, frv, fs, fs[:1].contiguous(), fsv, ft, ft, ftv)
    with pytest.raises(ValueError, match="contiguous"):
        fn(fr, fr, frv, fs, fs, fsv.transpose(2, 3).contiguous()
           .transpose(2, 3), ft, ft, ftv)
    with pytest.raises(ValueError, match="cpu"):
        fn(fr.cpu(), fr, frv, fs, fs, fsv, ft, ft, ftv)


def test_pair_count_launches_only_its_kernels_on_cuda(card):
    """The pair count at a B6-like layout (rows of 4,896 slots, ~980 live
    at the front, ~4 keys a row) launches its own kernels, counted on its
    own counter, and no sort or elementwise kernel: nothing is sorted,
    masked or zeroed by torch around it."""
    from repro_torch.kernels import cuda
    smoke = _smoke()
    gen = torch.Generator().manual_seed(17)
    ka, va = _bucket_rows(gen, (512, 4896), 4, 980, card)
    kb, vb = _bucket_rows(gen, (512, 4896), 4, 975, card)
    before = dict(cuda.LAUNCHES)
    got = ops.bucket_pair_count(ka, va, kb, vb)
    assert {k: cuda.LAUNCHES[k] - before[k] for k in cuda.KERNELS
            if cuda.LAUNCHES[k] != before[k]} == {"bucket_pair_count": 1}
    want = ops._bucket_pair_ref(ops._mask(ka, va, "a"),
                                ops._mask(kb, vb, "b"))
    assert torch.equal(got, want) and int(got.to(torch.int64).sum()) > 0
    by_name = _kernels_by_name(
        smoke, lambda: ops.bucket_pair_count(ka, va, kb, vb))
    assert smoke.sorts_and_masks(by_name) == [], by_name
    assert any("pair_sweep_kernel" in k for k in by_name), by_name


def test_pair_and_radix_wrappers_check_their_inputs(card):
    """The pair count takes raw keys and bool validity of the keys'
    shapes, contiguous, on the card, rows shared along size-1 batch
    dimensions; the radix histogram any contiguous view of its stream
    (one that starts mid-vector too) and 0 < n_buckets < 2^31."""
    from repro_torch.kernels import cuda
    gen = torch.Generator().manual_seed(19)
    ka = torch.randint(0, 5, (3, 1, 40), generator=gen,
                       dtype=torch.int32).to(card)
    kb = torch.randint(0, 5, (1, 4, 33), generator=gen,
                       dtype=torch.int32).to(card)
    va, vb = ka != 0, kb != 1
    got = cuda.bucket_pair_count(ka, va, kb, vb)
    assert got.shape == (3, 4)
    assert torch.equal(got, ops._bucket_pair_ref(ops._mask(ka, va, "a"),
                                                 ops._mask(kb, vb, "b")))
    with pytest.raises(TypeError, match="dtype"):
        cuda.bucket_pair_count(ka, va.int(), kb, vb)
    with pytest.raises(TypeError, match="dtype"):
        cuda.bucket_pair_count(ka, va, kb.long(), vb)
    with pytest.raises(ValueError, match="shape"):
        cuda.bucket_pair_count(ka, va, kb, vb[..., :4].contiguous())
    with pytest.raises(RuntimeError):   # batches that do not broadcast
        k2 = torch.zeros((2, 4, 33), dtype=torch.int32, device=card)
        cuda.bucket_pair_count(ka, va, k2, k2 != 0)
    with pytest.raises(ValueError, match="at most"):
        x = torch.zeros((1,) * 6 + (8,), dtype=torch.int32, device=card)
        cuda.bucket_pair_count(x, x != 0, x, x != 0)
    with pytest.raises(ValueError, match="contiguous"):
        t = kb.transpose(1, 2).contiguous().transpose(1, 2)
        cuda.bucket_pair_count(ka, va, t, vb)
    with pytest.raises(ValueError, match="cpu"):
        cuda.bucket_pair_count(ka, va, kb, vb.cpu())
    keys = torch.randint(-2**31, 2**31 - 1, (1003,), generator=gen,
                         dtype=torch.int32).to(card)
    valid = (torch.rand(1003, generator=gen) < 0.9).to(card)
    for k_off, v_off in ((1, 1), (2, 3), (3, 0)):
        k, v = keys[k_off:k_off + 1000], valid[v_off:v_off + 1000]
        assert torch.equal(cuda.radix_histogram(k, v, n_buckets=97),
                           ops._radix_histogram_ref(k, v, 97))
    with pytest.raises(ValueError, match="contiguous"):
        cuda.radix_histogram(keys[::2], valid[::2], n_buckets=4)
    with pytest.raises(ValueError, match="shape"):
        cuda.radix_histogram(keys, valid[1:], n_buckets=4)
    for nb in (0, -3, 2**31):
        with pytest.raises(ValueError, match="n_buckets"):
            cuda.radix_histogram(keys, valid, n_buckets=nb)


def test_flash_and_radix_launch_their_kernels_on_cuda(card):
    from repro_torch.kernels import cuda
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((2, 70, 4, 32), generator=gen).to(card, torch.bfloat16)
    k = torch.randn((2, 70, 2, 32), generator=gen).to(card, torch.bfloat16)
    v = torch.randn((2, 70, 2, 32), generator=gen).to(card, torch.bfloat16)
    pos = torch.arange(70, device=card)[None].expand(2, 70)
    before = dict(cuda.LAUNCHES)
    o = attention.flash_attention(q, k, v, pos, pos, causal=True, window=9)
    assert cuda.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    want = fa._flash_fwd_ref(q, k, v, causal=True, window=9)[0]
    assert torch.allclose(o.float(), want.float(), rtol=2e-2, atol=2e-2)
    with pytest.raises(ValueError, match="positions"):
        attention.flash_attention(q, k, v, pos + 1, pos + 1)
    keys = torch.randint(0, 100, (1000,), generator=gen,
                         dtype=torch.int32).to(card)
    valid = (torch.rand(1000, generator=gen) < 0.5).to(card)
    hist = ops.radix_histogram(keys, valid, n_buckets=17)
    assert cuda.LAUNCHES["radix_histogram"] == before["radix_histogram"] + 1
    assert torch.equal(hist, ops._radix_histogram_ref(keys, valid, 17))


def test_flash_and_radix_wrappers_check_their_inputs(card):
    from repro_torch.kernels import cuda
    q = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16, device=card)
    with pytest.raises(TypeError, match="dtype"):
        cuda.flash_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dim"):
        cuda.flash_fwd(q[..., :12], q[..., :12], q[..., :12])
    with pytest.raises(ValueError, match="unit stride"):
        t = q.transpose(1, 3).contiguous().transpose(1, 3)
        cuda.flash_fwd(t, q, q)
    with pytest.raises(ValueError, match="cpu"):
        cuda.flash_fwd(q, q.cpu(), q)
    keys = torch.zeros(10, dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="dtype"):
        cuda.radix_histogram(keys, keys, n_buckets=4)
    with pytest.raises(ValueError, match="n_buckets"):
        cuda.radix_histogram(keys, keys != 0, n_buckets=0)


def test_flash_attention_function_launches_both_kernels_on_cuda(card):
    from repro_torch.kernels import cuda
    from repro_torch.kernels import flash_attention as fa
    smoke = _smoke()
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(sh, generator=gen).to(card, torch.bfloat16)
               .requires_grad_() for sh in ((2, 90, 6, 64), (2, 90, 2, 64),
                                            (2, 90, 2, 64)))
    do = torch.randn((2, 90, 6, 64), generator=gen).to(card, torch.bfloat16)
    before = dict(cuda.LAUNCHES)
    o = fa.flash_attention_kernel(q, k, v, True, 33)
    o.backward(do)
    assert cuda.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    assert cuda.LAUNCHES["flash_bwd"] == before["flash_bwd"] + 1
    want = smoke._plain_grads(torch, fa, q, k, v, do,
                              dict(causal=True, window=33))
    err, ok = smoke.case_error(torch, "flash_bwd, autograd",
                               (q.grad, k.grad, v.grad), want)
    assert ok, err


def test_flash_bwd_wrapper_checks_its_inputs(card):
    from repro_torch.kernels import cuda
    q = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16, device=card)
    o, m, l = cuda.flash_fwd(q, q, q)
    with pytest.raises(TypeError, match="dtype"):
        cuda.flash_bwd(q, q, q, o, m, l, q.float())
    with pytest.raises(ValueError, match="unit stride"):
        t = q.transpose(1, 3).contiguous().transpose(1, 3)
        cuda.flash_bwd(q, q, q, o, m, l, t)
    with pytest.raises(ValueError, match="shape"):
        cuda.flash_bwd(q, q, q, o[:, :4], m, l, q)
    with pytest.raises(TypeError, match="dtype"):
        cuda.flash_bwd(q, q, q, o, m.double(), l, q)
    with pytest.raises(ValueError, match="cpu"):
        cuda.flash_bwd(q, q, q, o, m, l, q.cpu())


def test_train_step_launches_the_flash_kernels_on_cuda(card):
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import cuda
    from repro_torch.models import zoo
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, make_train_step
    cfg = dataclasses.replace(configs.smoke("qwen2-1.5b"), remat=True)
    model = zoo.build(cfg)
    state = init_train_state(model, torch.Generator(device=card)
                             .manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 65), generator=gen,
                         dtype=torch.int32).to(card)
    step = make_train_step(model, AdamWConfig(), accum_steps=2)
    before = dict(cuda.LAUNCHES)
    state, metrics = step(state, {"inputs": toks[:, :-1],
                                  "targets": toks[:, 1:]})
    assert cuda.LAUNCHES["flash_fwd"] - before["flash_fwd"] == \
        cfg.n_layers * 2 * 2       # 2 microbatches, remat
    assert cuda.LAUNCHES["flash_bwd"] - before["flash_bwd"] == \
        cfg.n_layers * 2
    assert torch.isfinite(metrics["loss"]) and int(state.step) == 1


@pytest.mark.parametrize("shape", [(2, 1024, 12, 2, 128, 0),
                                   (1, 600, 4, 4, 256, 512)])
def test_flash_bwd_is_bit_equal_across_calls_on_cuda(card, shape):
    """Two backward calls on the same inputs give the same bits: every
    output has one writer and the dkv kernel's per-query-head partials are
    summed in a fixed order (no atomics), so a training step is
    deterministic.  T1's microbatch (GQA 6:1, the partials' path) and
    D = 256 with one query head a kv head (dk, dv written directly)."""
    from repro_torch.kernels import flash_attention as fa
    b, s, h, kvh, d, window = shape
    gen = torch.Generator().manual_seed(11)
    q, do = (torch.randn((b, s, h, d), generator=gen).to(card, torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((b, s, kvh, d), generator=gen)
            .to(card, torch.bfloat16) for _ in range(2))
    o, m, l = fa.flash_fwd(q, k, v, causal=True, window=window)
    first = fa.flash_bwd(q, k, v, o, m, l, do, causal=True, window=window)
    again = fa.flash_bwd(q, k, v, o, m, l, do, causal=True, window=window)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_standing_triangle_launches_pairidx_in_its_deltas_on_cuda(card):
    """A small cyclic standing query: each delta re-runs the fused root,
    which launches the pair-index kernel on the card, and every
    ``DeltaRecord`` but ``exec_s`` equals the CPU port's."""
    import dataclasses

    import numpy as np

    from repro_torch.core.query import Query
    from repro_torch.core.relation import Relation
    from repro_torch.core.session import JoinSession
    from repro_torch.kernels import cuda
    rng = np.random.default_rng(21)
    n, d = 3000, 150
    data = {name: {c: rng.integers(0, d, n).astype(np.int32) for c in cols}
            for name, cols in (("R", "ab"), ("S", "bc"), ("T", "ca"))}
    deltas = [(name, {c: rng.integers(0, d, 40).astype(np.int32)
                      for c in data[name]}) for name in ("R", "S", "T", "S")]
    preds = [("R.b", "S.b"), ("S.c", "T.c"), ("T.a", "R.a")]
    out = {}
    for dev in ("cpu", card):
        rels = {k: Relation.from_arrays(device=dev, **v)
                for k, v in data.items()}
        sq = JoinSession(m_budget=128).watch(Query(rels, preds))
        cuda.reset_launch_counts()
        for name, batch in deltas:
            rels[name].append(**batch)
        launches = cuda.LAUNCHES["fused_count3_cyclic_pairidx"]
        recs = [dataclasses.replace(r, exec_s=0.0) for r in sq.delta_rounds]
        out[str(dev)] = (recs, int(sq.snapshot().count), launches)
        sq.close()
    (cpu_recs, cpu_count, cpu_launches), (recs, count, launches) = \
        out["cpu"], out[str(card)]
    assert recs == cpu_recs and count == cpu_count
    assert not any(r.replanned or r.overflowed for r in recs)
    assert cpu_launches == 0 and launches >= len(deltas)
