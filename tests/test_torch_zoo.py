"""The rest of the layer zoo against the JAX package: the Laplace and
diagonal Gaussian priors, the activations (LeakyRelu, LearnableLeakyRelu,
SmoothTanh with its Newton inverse, Identity, the RQ spline's global form,
the B-spline activation), the monotone cubic B-spline and its conditional
transformer, BSplineCoupling, SigmoidTransform, ActNormFC,
ActNormPlainLayer, UnSqueeze and SplitPriorFC.

Each layer is initialised in JAX from a PRNG seed, its params moved by
``params_from_jax`` (every leaf nudged off its init, so that zero-init
convs are seen), and both run on the same seeded numpy inputs.
Tolerances: outputs rtol 1e-5 (atol 1e-5), ldj rtol 1e-5 (atol 1e-4: sums
of a few hundred float32 terms), gradients 1e-4 by norm, as the earlier
slices hold them.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_flow_tpu import distributions as jd
from inverse_flow_tpu import layers as jl
from inverse_flow_tpu.layers import splines as jsplines
from inverse_flow_tpu_torch import distributions as td
from inverse_flow_tpu_torch import layers as tl
from inverse_flow_tpu_torch.bridge import params_from_jax, params_to_jax
from inverse_flow_tpu_torch.layers import splines as tsplines
from inverse_flow_tpu_torch.ops import activations as tact

B = 4

# name -> () -> (jax layer, torch layer, input shape without batch)
CASES = {
    "leaky_relu": lambda: (jl.LeakyRelu(0.1), tl.LeakyRelu(0.1), (3, 5, 5)),
    "learnable_leaky_relu": lambda: (jl.LearnableLeakyRelu(),
                                     tl.LearnableLeakyRelu(), (3, 5, 5)),
    "smooth_tanh": lambda: (jl.SmoothTanh(), tl.SmoothTanh(), (3, 5, 5)),
    "smooth_tanh_beta_0.01": lambda: (jl.SmoothTanh(1.0, 0.01),
                                      tl.SmoothTanh(1.0, 0.01), (3, 5, 5)),
    "identity": lambda: (jl.Identity(), tl.Identity(), (3, 5, 5)),
    "spline_global": lambda: (
        jl.SplineActivation((4, 6, 6), n_bins=5, tail_bound=3.0),
        tl.SplineActivation((4, 6, 6), n_bins=5, tail_bound=3.0,
                            individual_weights=False), (4, 6, 6)),
    "bspline_activation": lambda: (jl.BSplineActivation(n_bins=5,
                                                        tail_bound=6.0),
                                   tl.BSplineActivation(n_bins=5,
                                                        tail_bound=6.0),
                                   (4, 6, 6)),
    "bspline_coupling": lambda: (
        jl.BSplineCoupling((4, 6, 6), width=16, n_bins=5, tail_bound=6.0),
        tl.BSplineCoupling((4, 6, 6), width=16, n_bins=5, tail_bound=6.0),
        (4, 6, 6)),
    "sigmoid": lambda: (jl.SigmoidTransform(), tl.SigmoidTransform(),
                        (2, 4, 4)),
    "actnorm_fc": lambda: (jl.ActNormFC(12), tl.ActNormFC(12), (12,)),
    "unsqueeze": lambda: (jl.UnSqueeze(), tl.UnSqueeze(), (8, 3, 5)),
    "split_prior_fc": lambda: (jl.SplitPriorFC((12, 1, 1), width=16),
                               tl.SplitPriorFC((12, 1, 1), width=16),
                               (12,)),
}
# layers whose inverse is deterministic (SplitPriorFC's draws its half)
INVERTIBLE = [n for n in CASES if n != "split_prior_fc"]


def _nudged(params, seed):
    leaves, tree = jax.tree_util.tree_flatten(params)
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(l) + 0.05 * rs.randn(*np.shape(l)).astype(np.float32)
        for l in leaves])


def _pair(name):
    jlayer, tlayer, shape = CASES[name]()
    jparams, _ = jlayer.init(jax.random.PRNGKey(0), shape)
    jparams = _nudged(jparams, 1)
    params_from_jax(tl.Flow(None, [tlayer]), [jparams])
    return jlayer, tlayer, jparams, shape


def _input(shape, seed=0):
    x = 2.0 * np.random.RandomState(seed).randn(B, *shape)
    return x.astype(np.float32)


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", list(CASES))
def test_zoo_forward_matches_jax(name):
    jlayer, tlayer, jparams, shape = _pair(name)
    x = _input(shape)
    zj, lj = jax.jit(jlayer.forward)(jparams, jnp.asarray(x))
    with torch.no_grad():
        zt, lt = tlayer(torch.from_numpy(x))
    _close(zt.numpy(), zj)
    assert lt.shape == (B,) and lt.dtype == torch.float32
    _close(lt.numpy(), lj, atol=1e-4)


@pytest.mark.parametrize("name", INVERTIBLE)
def test_zoo_inverse_matches_jax_and_round_trips(name):
    """The inverse of JAX's output: the same values as JAX's inverse, and
    the input back (the Newton inverses to 1e-5 of max(1, |x|))."""
    jlayer, tlayer, jparams, shape = _pair(name)
    x = _input(shape)
    zj, _ = jax.jit(jlayer.forward)(jparams, jnp.asarray(x))
    xj = jax.jit(jlayer.inverse)(jparams, zj)
    with torch.no_grad():
        xt = tlayer.inverse(torch.from_numpy(np.asarray(zj)))
    _close(xt.numpy(), xj, atol=2e-5)
    _close(xt.numpy(), x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_zoo_gradients_match_jax(name):
    """d/d(x, params) of sum(z * g) + sum(ldj * h), against ``jax.grad``,
    each tensor to 1e-4 by norm."""
    jlayer, tlayer, jparams, shape = _pair(name)
    x = _input(shape)
    rs = np.random.RandomState(7)
    g = rs.randn(*jlayer.forward(jparams, jnp.asarray(x))[0].shape).astype(
        np.float32)
    h = rs.randn(B).astype(np.float32)

    def jloss(p, x):
        z, ldj = jlayer.forward(p, x)
        return jnp.sum(z * g) + jnp.sum(ldj * h)

    gp, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jparams,
                                                       jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    z, ldj = tlayer(xt)
    (torch.sum(z * torch.from_numpy(g)) + torch.sum(ldj * torch.from_numpy(
        h))).backward()
    pairs = [(xt.grad, gx)]
    theirs = dict(_flat(gp))
    pairs += [(p.grad, theirs[n]) for n, p in tlayer.named_parameters()]
    for ours, ref in pairs:
        ref = np.asarray(ref)
        err = np.linalg.norm(ours.numpy() - ref)
        assert err <= 1e-4 * max(np.linalg.norm(ref), 1e-6), (name, err)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("name", [n for n in CASES
                                  if n not in ("leaky_relu", "smooth_tanh",
                                               "smooth_tanh_beta_0.01",
                                               "identity", "sigmoid",
                                               "unsqueeze")])
def test_zoo_bridge_round_trip(name):
    """params_from_jax, then params_to_jax, gives the JAX tree back."""
    jlayer, tlayer, jparams, _ = _pair(name)
    back = params_to_jax(tl.Flow(None, [tlayer]))[0]
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jparams))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_actnorm_fc_data_init_and_plain_layer():
    """ActNormFC's data init over the batch axis, and ActNormPlainLayer's
    forward (the activation alone) against JAX's ``apply``."""
    x = _input((12,))
    jlayer = jl.ActNormFC(12)
    jparams = jlayer.data_init(jlayer.init(jax.random.PRNGKey(0), (12,))[0],
                               jnp.asarray(x))
    tlayer = tl.ActNormFC(12)
    tlayer.data_init(torch.from_numpy(x))
    for k in ("translation", "log_scale"):
        _close(getattr(tlayer, k).detach().numpy(), jparams[k])
    jplain = jl.ActNormPlainLayer(4)
    pp = _nudged(jplain.init(jax.random.PRNGKey(2), (4, 5, 5))[0], 3)
    tplain = tl.ActNormPlainLayer(4)
    params_from_jax(tl.Flow(None, [tplain]), [pp])
    x4 = _input((4, 5, 5))
    with torch.no_grad():
        out = tplain(torch.from_numpy(x4))
    _close(out.numpy(), jplain.apply(pp, jnp.asarray(x4)))


def test_split_prior_fc_inverse_with_the_same_half():
    """SplitPriorFC's inverse on a given factored-out half against JAX's
    on the same half, and the round trip through its forward."""
    jlayer, tlayer, jparams, shape = _pair("split_prior_fc")
    x = _input(shape)
    zj, _ = jlayer.forward(jparams, jnp.asarray(x))
    xj = jlayer.transform.forward(jparams, jnp.asarray(x).reshape(B, 12, 1,
                                                                  1))[0]
    half = np.asarray(xj)[:, 6:]
    with torch.no_grad():
        xt = tlayer.inverse(torch.from_numpy(np.asarray(zj)),
                            noise=torch.from_numpy(half))
    _close(xt.numpy(), x, atol=2e-5)
    with pytest.raises(ValueError):
        tlayer.inverse(torch.from_numpy(np.asarray(zj)))


# ---------------------------------------------------------------------------
# The monotone cubic B-spline and its conditional transformer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coeff_shape", [(8,), (B, 3, 4, 4, 8)],
                         ids=["global", "per-element"])
def test_monotone_cubic_b_spline_matches_jax(coeff_shape):
    """Forward values and logdets, the inverse (20 bisections, 5 Newton
    steps) and the forward's gradients, against JAX on inputs in [0, 1]
    with the ends included; the inverse of the forward gives x back."""
    rs = np.random.RandomState(3)
    x = rs.uniform(0, 1, (B, 3, 4, 4)).astype(np.float32)
    x.reshape(-1)[:2] = [0.0, 1.0]
    c = (0.5 * rs.randn(*coeff_shape)).astype(np.float32)
    spline = jax.jit(jsplines.monotone_cubic_b_spline,
                     static_argnames="inverse")
    yj, lj = spline(jnp.asarray(x), jnp.asarray(c))
    xt, ct = torch.from_numpy(x).requires_grad_(), torch.from_numpy(
        c).requires_grad_()
    yt, lt = tsplines.monotone_cubic_b_spline(xt, ct)
    _close(yt.detach().numpy(), yj)
    _close(lt.detach().numpy(), lj, atol=1e-5)
    gj = jax.jit(jax.grad(lambda x, c: jnp.sum(jnp.sum(jnp.stack(
        jsplines.monotone_cubic_b_spline(x, c)), 0) ** 2), argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(c))
    (torch.stack([yt, lt]).sum(0) ** 2).sum().backward()
    for ours, ref in ((xt.grad, gj[0]), (ct.grad, gj[1])):
        ref = np.asarray(ref)
        assert np.linalg.norm(ours.numpy() - ref) <= 1e-4 * np.linalg.norm(
            ref)
    inv_j, inv_lj = spline(yj, jnp.asarray(c), inverse=True)
    with torch.no_grad():
        inv_t, inv_lt = tsplines.monotone_cubic_b_spline(
            torch.from_numpy(np.asarray(yj)), torch.from_numpy(c),
            inverse=True)
    _close(inv_t.numpy(), inv_j)
    _close(inv_lt.numpy(), inv_lj, atol=1e-5)
    _close(inv_t.numpy(), x, atol=1e-5)


def test_conditional_b_spline_transformer_matches_jax():
    """On [-2, 3) -> [0, 5): the forward and inverse with their ldj,
    against JAX, from a network output of y_dim * (n_bins + 3)."""
    rs = np.random.RandomState(4)
    y = rs.uniform(-2, 3, (B, 6)).astype(np.float32)
    net = (0.3 * rs.randn(B, 6 * 11)).astype(np.float32)
    jt = jsplines.ConditionalBSplineTransformer(6, n_bins=8, left=-2.0,
                                                right=3.0, bottom=0.0,
                                                top=5.0)
    tt = tl.ConditionalBSplineTransformer(6, n_bins=8, left=-2.0, right=3.0,
                                          bottom=0.0, top=5.0)
    zj, lj = jt.forward(jnp.asarray(net), jnp.asarray(y))
    zt, lt = tt.forward(torch.from_numpy(net), torch.from_numpy(y))
    _close(zt.numpy(), zj)
    _close(lt.numpy(), lj)
    yj, lij = jt.inverse(jnp.asarray(net), zj)
    yt, lit = tt.inverse(torch.from_numpy(net), torch.from_numpy(
        np.asarray(zj)))
    _close(yt.numpy(), yj)
    _close(lit.numpy(), lij)
    _close(yt.numpy(), y, atol=1e-5)


# ---------------------------------------------------------------------------
# SmoothTanh's Newton inverse: the kernel's exit on the reference loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta", [0.1, 0.01])
def test_smooth_tanh_exit_lands_within_the_cycle(beta):
    """On a grid of y in [-40, 40] at alpha 1: the kernel's exit test
    (SLR_EXIT_TOL) on the plain loop settles most y within 3 steps; where
    it settles, x is within 2 x SLR_EXIT_TOL x max(1, |x|) of the
    100-step x; where the iterate keeps cycling wider than the test (about
    0.1% of y), x after any step past the first 20 lies within the
    cycle's width of the 100-step x. JAX's 100-step loop, whose tanh
    rounds otherwise, lands within that width of the plain loop's, or
    within the inverse's own rounding where both settle on different
    floats of the flat residual: 4 x 2^-23 x max(1, |y|) / f'(x)."""
    y = torch.linspace(-40.0, 40.0, 20001)
    ref = tact.smooth_tanh_inverse_reference(y, 1.0, beta)
    assert torch.equal(tact.smooth_tanh_inverse(y, 1.0, beta), ref)
    steps = tact.smooth_tanh_inverse_steps(y, 1.0, beta,
                                           tol=tact.SLR_EXIT_TOL)
    assert steps.float().median() <= 3
    assert (steps == tact.NEWTON_ITERS).float().mean() < 0.005
    hist = tact.smooth_tanh_inverse_history(y, 1.0, beta)
    assert torch.equal(hist[-1], ref)
    settled = steps < tact.NEWTON_ITERS
    at = hist.gather(0, (steps.long() - 1)[None])[0]
    scale = ref.abs().clamp(min=1.0)
    assert ((at - ref).abs() / scale)[settled].max() <= 2 * tact.SLR_EXIT_TOL
    width = hist[20:].max(0).values - hist[20:].min(0).values
    assert ((hist[20:] - ref).abs() <= width).all()
    assert (width / scale)[~settled].max() <= 1e-5
    jref = np.asarray(jl.SmoothTanh(1.0, beta).inverse(
        {}, jnp.asarray(y.numpy())))
    assert (np.abs(jref - ref.numpy()) <= tact.smooth_tanh_inverse_limit(
        y, hist, 1.0, beta, exit_tol=0.0).numpy()).all()


def test_smooth_tanh_inverse_wrapper_checks():
    """The CPU tensor takes the plain loop and counts no launch; another
    device than the card raises."""
    y = torch.linspace(-5, 5, 64)
    before = tact.smooth_tanh_inverse.launches
    assert torch.equal(tact.smooth_tanh_inverse(y, 1.0, 0.1),
                       tact.smooth_tanh_inverse_reference(y, 1.0, 0.1))
    assert tact.smooth_tanh_inverse.launches == before
    with pytest.raises(ValueError):
        tact.smooth_tanh_inverse(y.to("meta"), 1.0, 0.1)


# ---------------------------------------------------------------------------
# Priors
# ---------------------------------------------------------------------------

def test_laplace_prior_matches_jax():
    """log p(x) against JAX; a sample's reported density is its own, and
    its std is 1."""
    x = _input((3, 4, 4))
    jp, tp = jd.LaplacePrior((3, 4, 4)), td.LaplacePrior((3, 4, 4))
    _close(tp.log_prob(torch.from_numpy(x)).numpy(),
           jp.log_prob(jnp.asarray(x)))
    s, lp = tp.sample(torch.Generator().manual_seed(0), 2000)
    assert s.shape == (2000, 3, 4, 4) and torch.isfinite(s).all()
    _close(lp.numpy(), jp.log_prob(jnp.asarray(s.numpy())))
    assert abs(s.std().item() - 1.0) < 0.02
    assert abs(s.abs().mean().item() - 1 / math.sqrt(2)) < 0.01


def test_diagonal_gaussian_prior_matches_jax():
    """log_prob with the NaN/inf scrub and the clip, nll, and a sample's
    density taken from its own draw (not the cleaned and clipped point),
    against JAX on the same draw."""
    rs = np.random.RandomState(5)
    mean = rs.randn(12).astype(np.float32)
    log_std = (0.5 * rs.randn(12)).astype(np.float32) + 1.5
    jp = jd.DiagonalGaussianPrior((3, 2, 2), mean, log_std)
    tp = td.DiagonalGaussianPrior((3, 2, 2), torch.from_numpy(mean),
                                  torch.from_numpy(log_std))
    x = (20 * rs.randn(B, 3, 2, 2)).astype(np.float32)
    x.reshape(-1)[:3] = [np.nan, np.inf, -np.inf]
    _close(tp.log_prob(torch.from_numpy(x)).numpy(),
           jp.log_prob(jnp.asarray(x)))
    _close(tp.nll(torch.from_numpy(x)).item(), jp.nll(jnp.asarray(x)))
    s, lp = tp.sample(torch.Generator().manual_seed(1), 64)
    eps = (s.reshape(64, 12).numpy() - mean) * np.exp(-log_std)
    dens = (-0.5 * eps ** 2 - log_std - 0.5 * math.log(2 * math.pi)).sum(-1)
    _close(lp.numpy(), dens, atol=1e-4)
    assert (np.abs(s.numpy()) > 10).any()        # past the clip
    js, jlp = jp.sample(jax.random.PRNGKey(0), 64)
    jeps = (np.asarray(js).reshape(64, 12) - mean) * np.exp(-log_std)
    _close(np.asarray(jlp), (-0.5 * jeps ** 2 - log_std
                             - 0.5 * math.log(2 * math.pi)).sum(-1),
           atol=1e-4)
    unit = td.DiagonalGaussianPrior(12)
    _close(unit.log_prob(torch.from_numpy(x.reshape(B, 12))).numpy(),
           jd.DiagonalGaussianPrior(12).log_prob(jnp.asarray(
               x.reshape(B, 12))))


def test_sigmoid_transform_is_stable_at_large_inputs():
    """At |x| up to 120, where a naive 1/(1+exp(-x)) overflows, the
    forward, its ldj and its gradient stay finite and match JAX's."""
    x = np.array([[-120.0, -90.0, 0.5, 90.0, 120.0]], np.float32)
    jlayer = jl.SigmoidTransform()
    zj, lj = jlayer.forward({}, jnp.asarray(x))
    gj = jax.grad(lambda x: jnp.sum(jlayer.forward({}, x)[1]))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    zt, lt = tl.SigmoidTransform()(xt)
    lt.sum().backward()
    assert torch.isfinite(lt).all() and torch.isfinite(xt.grad).all()
    _close(zt.detach().numpy(), zj)
    _close(lt.detach().numpy(), lj)
    _close(xt.grad.numpy(), gj)
