"""Every layer of the port's scoring slice against its JAX counterpart.

Each case builds the JAX layer, initialises it from a PRNG seed, carries
the params over with ``params_from_jax``, and runs both forwards on the
same numpy input. Tolerances: rtol 1e-5 with atol 1e-5 on outputs and
1e-4 on ldj, float32 round-off of elementwise maps and of sums over a few
hundred elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_flow_tpu import distributions as jd
from inverse_flow_tpu import layers as jl
from inverse_flow_tpu_torch import distributions as td
from inverse_flow_tpu_torch import layers as tl
from inverse_flow_tpu_torch.bridge import params_from_jax

B = 4
ALPHA = 1e-7


def _step_pair(size, width=8):
    c = size[0]
    jax_step = (jl.ActNorm(c), jl.InvFlowNoPad(c, (3, 3)),
                jl.SplineActivation(size, n_bins=5, tail_bound=3.0,
                                    individual_weights=True),
                jl.Coupling(size, width=width))

    def torch_step():
        return [tl.ActNorm(c), tl.InvFlowNoPad(c, (3, 3)),
                tl.SplineActivation(size, n_bins=5, tail_bound=3.0),
                tl.Coupling(size, width=width)]
    return jax_step, torch_step


def _repeated_pair():
    jax_step, torch_step = _step_pair((4, 6, 6))
    return (jl.RepeatedBlock(jax_step, 2), tl.RepeatedBlock(torch_step, 2),
            (4, 6, 6))


# name -> () -> (jax layer, torch layer, input shape without batch)
CASES = {
    "normalization": lambda: (jl.Normalization(0.0, 256.0),
                              tl.Normalization(0.0, 256.0), (1, 8, 8)),
    "normalization_alpha": lambda: (
        jl.Normalization(-ALPHA, 1.0 / (1.0 - 2.0 * ALPHA)),
        tl.Normalization(-ALPHA, 1.0 / (1.0 - 2.0 * ALPHA)), (1, 8, 8)),
    "logit": lambda: (jl.LogitTransform(), tl.LogitTransform(), (1, 8, 8)),
    "squeeze": lambda: (jl.Squeeze(), tl.Squeeze(), (2, 8, 6)),
    "actnorm": lambda: (jl.ActNorm(4), tl.ActNorm(4), (4, 6, 6)),
    "inv_flow_no_pad": lambda: (jl.InvFlowNoPad(4, (3, 3)),
                                tl.InvFlowNoPad(4, (3, 3)), (4, 14, 14)),
    "inv_flow_no_pad_defaults": lambda: (jl.InvFlowNoPad(4),
                                         tl.InvFlowNoPad(4), (4, 14, 14)),
    "inv_flow_br": lambda: (jl.InvFlow(8, (3, 3), order="BR"),
                            tl.InvFlow(8, (3, 3), order="BR"), (8, 7, 7)),
    "spline": lambda: (
        jl.SplineActivation((4, 6, 6), n_bins=5, tail_bound=3.0,
                            individual_weights=True),
        tl.SplineActivation((4, 6, 6), n_bins=5, tail_bound=3.0), (4, 6, 6)),
    "coupling": lambda: (jl.Coupling((4, 6, 6), width=16),
                         tl.Coupling((4, 6, 6), width=16), (4, 6, 6)),
    "split_prior": lambda: (jl.SplitPrior((4, 6, 6), width=16),
                            tl.SplitPrior((4, 6, 6), width=16), (4, 6, 6)),
    "repeated_block": _repeated_pair,
}


def _input(name, shape, seed=0):
    rs = np.random.RandomState(seed)
    if name == "logit":
        return rs.uniform(1e-3, 1 - 1e-3, (B,) + shape).astype(np.float32)
    if name == "normalization":
        return rs.randint(0, 256, (B,) + shape).astype(np.float32)
    return (2.0 * rs.randn(B, *shape)).astype(np.float32)


def _randomize(params, seed):
    """Nonzero values for every leaf (Coupling's last conv starts at zero,
    which would hide it), small enough to keep the flow well-conditioned."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rs = np.random.RandomState(seed)
    leaves = [np.asarray(l) + 0.05 * rs.randn(*np.shape(l)).astype(np.float32)
              for l in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


def _load(tlayer, jparams):
    params_from_jax(tl.Flow(None, [tlayer]), [jparams])


@pytest.mark.parametrize("name", list(CASES))
def test_layer_forward_matches_jax(name):
    jlayer, tlayer, shape = CASES[name]()
    jparams, _ = jlayer.init(jax.random.PRNGKey(0), shape)
    jparams = _randomize(jparams, 1)
    _load(tlayer, jparams)
    x = _input(name, shape)
    zj, lj = jax.jit(jlayer.forward)(jparams, jnp.asarray(x))
    with torch.no_grad():
        zt, lt = tlayer(torch.from_numpy(x))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-5,
                               atol=1e-5)
    assert lt.shape == (B,) and lt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-4)


def test_dequantization_matches_jax_with_same_noise():
    x = _input("normalization", (1, 8, 8))
    jlayer = jl.Dequantization(jd.UniformDistribution((1, 8, 8)))
    zj, lj = jlayer.forward({}, jnp.asarray(x), rng=jax.random.PRNGKey(3))
    noise = torch.from_numpy(np.asarray(zj) - x)
    tlayer = tl.Dequantization(td.UniformDistribution((1, 8, 8)))
    zt, lt = tlayer(torch.from_numpy(x), noise=noise)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=0)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    # drawn noise lies in [0, 1) and has the uniform's zero ldj
    zg, lg = tlayer(torch.from_numpy(x),
                    generator=torch.Generator().manual_seed(0))
    u = zg.numpy() - x
    assert (u >= 0).all() and (u < 1).all() and not lg.any()


@pytest.mark.parametrize("name", ["actnorm", "repeated_block"])
def test_data_init_matches_jax(name):
    jlayer, tlayer, shape = CASES[name]()
    jparams, _ = jlayer.init(jax.random.PRNGKey(0), shape)
    _load(tlayer, jparams)
    x = _input(name, shape, seed=2) + 1.5
    jnew = jax.jit(jlayer.data_init)(jparams, jnp.asarray(x))
    tlayer.data_init(torch.from_numpy(x))
    for n, p in tlayer.named_parameters():
        ref = jnew
        for k in n.split("."):
            ref = ref[int(k)] if isinstance(ref, (list, tuple)) else ref[k]
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_gaussian_prior_matches_jax():
    x = _input("actnorm", (4, 6, 6))
    ref = jd.GaussianPrior((4, 6, 6)).log_prob(jnp.asarray(x))
    ours = td.GaussianPrior((4, 6, 6)).log_prob(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)
    z, lp = td.GaussianPrior((4, 6, 6)).sample(
        torch.Generator().manual_seed(0), 3)
    assert z.shape == (3, 4, 6, 6)
    np.testing.assert_allclose(lp.numpy(), np.asarray(
        jd.GaussianPrior((4, 6, 6)).log_prob(jnp.asarray(z.numpy()))),
        rtol=1e-6)


def test_spline_bin_edges_match_jax():
    """Inputs on the knots and on the tail bounds take the same bins as in
    the JAX package (its searchsorted adds eps to the last edge)."""
    from inverse_flow_tpu.layers import splines as js
    from inverse_flow_tpu_torch.layers import splines as ts
    rs = np.random.RandomState(5)
    w, h = rs.randn(2, 1, 5).astype(np.float32)
    d = rs.randn(1, 4).astype(np.float32)
    knots = np.concatenate([[-3.0], -3.0 + 6.0 * np.cumsum(
        np.exp(w[0]) / np.exp(w[0]).sum())]).astype(np.float32)
    x = np.concatenate([knots, [3.0, -3.0, 2.999999, 5.0]])
    x = x.astype(np.float32).reshape(-1)
    args = [np.broadcast_to(a, x.shape + a.shape[1:]).copy()
            for a in (w, h, d)]
    zj, lj = js.unconstrained_rational_quadratic_spline(
        jnp.asarray(x), *map(jnp.asarray, args), tail_bound=3.0)
    zt, lt = ts.unconstrained_rational_quadratic_spline(
        torch.from_numpy(x), *map(torch.from_numpy, args), tail_bound=3.0)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-5)


def test_bridge_rejects_mismatched_params():
    layer = tl.ActNorm(4)
    with pytest.raises(ValueError):
        _load(layer, {"translation": np.zeros(4)})
    with pytest.raises(ValueError):
        _load(layer, {"translation": np.zeros(3), "log_scale": np.zeros(3)})


def test_inv_flow_other_solvers_raise():
    """Every JAX solver name builds (``'jacobi'`` and ``'auto'`` are
    ported); an unknown one raises."""
    for solver in ("auto", "exact", "fused", "jacobi"):
        assert tl.InvFlowNoPad(4, (3, 3), solver=solver).solver == solver
    with pytest.raises(ValueError):
        tl.InvFlowNoPad(4, (3, 3), solver="newton")
