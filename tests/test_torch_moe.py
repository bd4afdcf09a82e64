"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the CPU, in float32.

The JAX package's ``init_moe`` parameters are carried across; both
packages then route the same seeded tokens.  Configs: qwen3-moe's smoke
config (top-2 of 8 experts, QK-norm model) and moonshot's (top-2 of 8
with a shared expert).  At ``capacity_factor`` 1.25 some experts overflow
at random init; at 0.5 drops are forced.

Tolerances: the routing (which assignments are kept) and ``dropped`` are
exact: the same top-k experts and the same ranks within each expert give
the same kept set, and the share is the same f32 arithmetic (the JAX
package's ``1 - kept / (n k)`` as XLA compiles it: a fused
multiply-subtract with the f32 reciprocal of n k).  The output,
the load-balance loss and the gradients agree within ``TOL`` = 1e-5
relative and 1e-5 of each array's largest |value| (the frameworks sum the
products in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import layers, moe

TOL = 1e-5
ARCHS = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"]
B, S = 2, 24


def _close(got, want, tol=TOL, err_msg=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The JAX package's init_moe tree (numpy leaves) and the input x."""
    cfg = jconfigs.smoke(arch)
    tree = jax.tree.map(np.asarray,
                        jmoe.init_moe(jax.random.key(11), cfg))
    x = np.random.default_rng(5).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)
    return tree, x


def _port_moe(tree) -> moe.MoE:
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    shared = None
    if "shared" in tree:
        shared = layers.GLUMLP(*(layers.Linear(t(tree["shared"][n]["w"]))
                                 for n in ("gate", "up", "down")))
    return moe.MoE(layers.Linear(t(tree["router"]["w"])), t(tree["gate"]),
                   t(tree["up"]), t(tree["down"]), shared)


def _cfgs(arch):
    return configs.smoke(arch), jconfigs.smoke(arch)


@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_matches_repro(arch, factor):
    cfg, jcfg = _cfgs(arch)
    tree, x = _params(arch)
    out, aux = moe.moe_mlp(torch.from_numpy(x), _port_moe(tree), cfg,
                           capacity_factor=factor)
    jout, jaux = jax.jit(lambda x, p: jmoe.moe_mlp(
        x, p, jcfg, capacity_factor=factor))(jnp.asarray(x), tree)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert aux["dropped"].dtype == aux["aux_loss"].dtype == torch.float32
    assert aux["dropped"].shape == aux["aux_loss"].shape == ()
    assert float(aux["dropped"]) == float(jaux["dropped"])
    if factor < 1:
        assert float(aux["dropped"]) > 0.1      # drops are forced
    _close(_np(out), jout)
    _close(_np(aux["aux_loss"]), jaux["aux_loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_gradients_match_repro(arch):
    """d(sum(out * r) + aux_loss) by every weight and by x, at the drops
    of capacity_factor 0.5 (dropped assignments get no gradient)."""
    cfg, jcfg = _cfgs(arch)
    tree, x = _params(arch)
    r = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_mlp(x, p, jcfg, capacity_factor=0.5)
        return jnp.sum(out * r) + aux["aux_loss"]

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(tree, jnp.asarray(x))
    p = _port_moe(tree)
    xt = torch.from_numpy(x.copy()).requires_grad_()
    out, aux = moe.moe_mlp(xt, p, cfg, capacity_factor=0.5)
    (torch.sum(out * torch.from_numpy(r)) + aux["aux_loss"]).backward()
    _close(_np(xt.grad), jgx, err_msg="dx")
    for name, param in p.named_parameters():
        want = jg
        for part in name.split("."):
            want = want[part]
        _close(_np(param.grad), want, err_msg=f"d{name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_dense_ref_matches_repro_and_the_dispatch(arch):
    """The dense oracle equals the JAX package's, and the dispatch path
    equals it where nothing can drop (capacity_factor 8 = E / k)."""
    cfg, jcfg = _cfgs(arch)
    tree, x = _params(arch)
    p = _port_moe(tree)
    ref = moe.moe_mlp_dense_ref(torch.from_numpy(x), p, cfg)
    jref = jax.jit(lambda x, p: jmoe.moe_mlp_dense_ref(x, p, jcfg))(
        jnp.asarray(x), tree)
    _close(_np(ref), jref)
    factor = cfg.n_experts / cfg.top_k
    out, aux = moe.moe_mlp(torch.from_numpy(x), p, cfg,
                           capacity_factor=factor)
    _, jaux = jax.jit(lambda x, p: jmoe.moe_mlp(
        x, p, jcfg, capacity_factor=factor))(jnp.asarray(x), tree)
    # nothing kept out: 1 - (n k)·f32(1/(n k)), the JAX package's value
    assert float(aux["dropped"]) == float(jaux["dropped"])
    assert abs(float(aux["dropped"])) < 1e-7
    _close(_np(out), _np(ref))


def test_capacity_matches_repro():
    for n, e, k, f in [(1, 8, 2, 1.25), (48, 8, 2, 1.25), (48, 8, 2, 0.5),
                       (8192, 128, 8, 1.25), (2112, 128, 8, 1.25),
                       (8, 128, 8, 1.25), (2048, 128, 8, 16.0),
                       (100, 64, 6, 1.0)]:
        assert moe._capacity(n, e, k, f) == jmoe._capacity(n, e, k, f)
    # decode at batch <= 8 never drops: capacity >= tokens
    assert all(moe._capacity(b, 128, 8) >= b for b in range(1, 9))


def test_ties_go_to_the_lower_expert():
    """Equal router probabilities: the top-k are the lowest indices, as
    ``jax.lax.top_k`` picks them."""
    cfg = configs.smoke("qwen3-moe-30b-a3b")
    tree, _ = _params("qwen3-moe-30b-a3b")
    tree = dict(tree, router={"w": np.zeros_like(tree["router"]["w"])})
    x = np.ones((1, 3, cfg.d_model), np.float32)
    _, top_p, top_i = moe._route(torch.from_numpy(x.reshape(3, -1)),
                                 _port_moe(tree), cfg)
    assert top_i.tolist() == [[0, 1]] * 3
    jtop = jax.lax.top_k(jnp.full((3, cfg.n_experts), 0.125), cfg.top_k)[1]
    assert np.asarray(jtop).tolist() == top_i.tolist()


def test_init_moe_shapes_and_scales():
    cfg = configs.smoke("moonshot-v1-16b-a3b")
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    jtree = jmoe.init_moe(jax.random.key(0), jconfigs.smoke(
        "moonshot-v1-16b-a3b"))
    got = {n: tuple(t.shape) for n, t in p.named_parameters()}
    want = {jax.tree_util.keystr(path, simple=True, separator="."):
            tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jtree)}
    assert got == want
    assert abs(float(p.down.detach().std()) * np.sqrt(cfg.moe_d_ff)
               - 1) < 0.05
    assert all(t.requires_grad for t in p.parameters())


def test_moe_mlp_auto_is_the_single_card_path_and_sharded_raises():
    cfg = configs.smoke("qwen3-moe-30b-a3b")
    tree, x = _params("qwen3-moe-30b-a3b")
    p = _port_moe(tree)
    xt = torch.from_numpy(x)
    out, aux = moe.moe_mlp_auto(xt, p, cfg)
    want, waux = moe.moe_mlp(xt, p, cfg)
    assert torch.equal(out, want) and torch.equal(aux["dropped"],
                                                  waux["dropped"])
    # the expert-parallel path needs the LM's mesh (a DeviceMesh context;
    # tests/test_torch_lm_mesh.py runs it on gloo ranks)
    with pytest.raises(RuntimeError, match="the LM's mesh"):
        moe.moe_mlp_sharded(xt, p, cfg)
