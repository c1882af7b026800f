"""The last two elementwise inverses on their kernels, on the CPU.

* ``ops/bspline.py:bspline_inverse`` in its three coefficient layouts
  (one shared set, channel-major from a coupling net, the last dim)
  against JAX's ``monotone_cubic_b_spline(..., inverse=True)`` on seeded
  numpy inputs: x to 1e-6 and the log-det to 1e-5 (float32, x in [0, 1],
  the log-det within a few units), and bit for bit against the plain
  version with the coefficients permuted to the last dim; the wrapper's
  checks; each B-spline layer's inverse goes through it in its own layout.
* A B-spline Glow (L=2 x K=2, width 16, 5 bins, at (1, 8, 8)) carried from
  JAX through ``bridge.py``: log p(x) to rtol 1e-5 and ``Flow.sample`` on
  JAX's own draws to 1e-4 by norm.
* The SmoothTanh kernel's exit rule (the step test or the residual test,
  each lane on its own), emulated on the plain loop over 20,001 y in
  [-40, 40]: every x within ``smooth_tanh_inverse_limit`` of the 100-step
  x, no element past ``TANH_MAX_STEPS`` steps.
* ``cuda``-marked card tests of both kernels against their plain versions
  (they skip without a card; the card is decided inside the test). On the
  card: ``python -m pytest --noconftest -m cuda
  tests/test_torch_bspline_kernel.py``. JAX is imported inside the tests
  that use it: the card's machine has none.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from inverse_flow_tpu_torch import layers as tl
from inverse_flow_tpu_torch.ops import activations as tact
from inverse_flow_tpu_torch.ops import bspline as ob

# the most Newton steps the kernel's exit rule needs on the plain loop over
# y in [-40, 40] at alpha 1, beta 0.1 or 0.01 (5 and 7 on this grid, 5 and
# 8 on 200,001 points)
TANH_MAX_STEPS = 8
SIZE = (1, 8, 8)
KW = dict(num_blocks=2, block_size=2, coupling_width=16, activation="BSpline",
          n_bins=5, tail_bound=6.0)
N = 8


def _operands(layout, shape=(4, 6, 5, 5), k=8, seed=0):
    """y in [-0.02, 1.02] (clipped by the spline) of ``shape``, and raw
    coefficients at std 0.5 in ``layout``."""
    rs = np.random.RandomState(seed)
    y = rs.uniform(-0.02, 1.02, shape).astype(np.float32)
    if layout == "shared":
        c = rs.randn(k + 3)
    elif layout == "channels":
        c = rs.randn(shape[0], shape[1] * (k + 3), *shape[2:])
    else:
        c = rs.randn(*shape, k + 3)
    return torch.from_numpy(y), torch.from_numpy((0.5 * c).astype(np.float32))


@pytest.mark.parametrize("k", [5, 8])
@pytest.mark.parametrize("layout", ob.LAYOUTS)
def test_bspline_inverse_cpu_matches_jax(layout, k):
    """On the CPU: x and the log-det against JAX's inverse on the
    coefficients in the last dim; bit for bit the plain version on the
    coefficients permuted to the last dim; no launch counted."""
    import jax.numpy as jnp

    from inverse_flow_tpu.layers import splines as jsplines

    y, c = _operands(layout, k=k)
    last = ob.last_dim_coeffs(y, c, layout)
    before = ob.bspline_inverse.launches
    x, ld = ob.bspline_inverse(y, c, layout)
    assert ob.bspline_inverse.launches == before
    x_ref, ld_ref = ob.monotone_cubic_b_spline(y, last.contiguous(),
                                               inverse=True)
    assert torch.equal(x, x_ref) and torch.equal(ld, ld_ref)
    xj, ldj = jsplines.monotone_cubic_b_spline(
        jnp.asarray(y.numpy()), jnp.asarray(last.contiguous().numpy()),
        inverse=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ldj), rtol=0,
                               atol=1e-5)
    # the inverse undoes the forward on [0, 1]
    back = ob.monotone_cubic_b_spline(x, last)[0]
    assert (back - y.clamp(0, 1)).abs().max() <= 1e-5


def test_channel_major_layout_is_the_permuted_net_output():
    """Coefficient k of channel c sits at channel c * (K+3) + k: the
    "channels" view equals BSplineCoupling's reshape and permute."""
    y, c = _operands("channels", shape=(2, 3, 4, 5), k=5)
    view = ob.last_dim_coeffs(y, c, "channels")
    assert view.shape == (2, 3, 4, 5, 8)
    ref = c.reshape(2, 3, 8, 4, 5).permute(0, 1, 3, 4, 2)
    assert torch.equal(view, ref)
    assert view[1, 2, 3, 4, 6] == c[1, 2 * 8 + 6, 3, 4]


def test_bspline_inverse_wrapper_checks():
    """Unknown layouts, coefficients that do not fit y, and another device
    than the card (for y or the coefficients) raise."""
    y, c = _operands("channels")
    with pytest.raises(ValueError):
        ob.bspline_inverse(y, c, "rows")
    with pytest.raises(ValueError):
        ob.bspline_inverse(y, c[:, :-1], "channels")
    with pytest.raises(ValueError):
        ob.bspline_inverse(y[:, :, :-1], c, "channels")
    with pytest.raises(ValueError):
        ob.bspline_inverse(y.to("meta"), c.to("meta"), "channels")
    with pytest.raises(ValueError):
        ob.bspline_inverse(y, c.to("meta"), "channels")
    yl, cl = _operands("last")
    with pytest.raises(ValueError):
        ob.bspline_inverse(yl, cl[:1], "last")
    with pytest.raises(ValueError):
        ob.bspline_inverse(yl, cl, "shared")


class _Recorder:
    """Stands in for ``ops.bspline.bspline_inverse``: records each
    call's layout and coefficient shape, runs the plain version with the
    call's extras."""

    def __init__(self):
        self.calls = []

    def __call__(self, y, coeffs, layout, **extras):
        self.calls.append((layout, tuple(coeffs.shape)))
        return ob.bspline_inverse_reference(y, coeffs, layout, **extras)


def _layer_case(name):
    """(run(): the inverse, its result by the plain path, expected
    (layout, coefficient shape))."""
    rs = np.random.RandomState(3)
    if name == "activation":
        layer = tl.BSplineActivation(n_bins=5, tail_bound=6.0)
        with torch.no_grad():
            layer.coeffs.copy_(torch.from_numpy(
                (0.5 * rs.randn(8)).astype(np.float32)))
        z = torch.from_numpy((3 * rs.randn(2, 4, 5, 5)).astype(np.float32))

        def plain():
            u = ob.clip01((z + 6.0) / 12.0)
            out = ob.monotone_cubic_b_spline(u, layer.coeffs, inverse=True)[0]
            inside = (z > -6.0) & (z < 6.0)
            return torch.where(inside, out * 12.0 - 6.0, z)
        return lambda: layer.inverse(z), plain, ("shared", (8,))
    if name == "coupling":
        layer = tl.BSplineCoupling((4, 5, 5), width=8, n_bins=5,
                                   tail_bound=6.0)
        with torch.no_grad():
            layer.w3.copy_(torch.from_numpy(
                (0.1 * rs.randn(*layer.w3.shape)).astype(np.float32)))
        z = torch.from_numpy((3 * rs.randn(2, 4, 5, 5)).astype(np.float32))

        def plain():
            p = layer.own_params()
            h = layer._net(p, z[:, :2]).reshape(2, 2, 8, 5, 5).permute(
                0, 1, 3, 4, 2)
            z2 = z[:, 2:]
            u = ob.clip01((z2 + 6.0) / 12.0)
            out = ob.monotone_cubic_b_spline(u, h, inverse=True)[0]
            inside = (z2 > -6.0) & (z2 < 6.0)
            return torch.cat([z[:, :2], torch.where(inside, out * 12.0 - 6.0,
                                                    z2)], 1)
        return lambda: layer.inverse(z), plain, ("channels", (2, 16, 5, 5))
    tr = tl.ConditionalBSplineTransformer(3, n_bins=5, left=-2.0, right=3.0,
                                          bottom=0.0, top=5.0)
    net = torch.from_numpy((0.3 * rs.randn(4, 24)).astype(np.float32))
    z = torch.from_numpy(rs.uniform(0, 5, (4, 3)).astype(np.float32))

    def plain():
        out = ob.monotone_cubic_b_spline(z / 5.0, net.reshape(4, 3, 8),
                                         inverse=True)[0]
        return out * 5.0 - 2.0
    return lambda: tr.inverse(net, z)[0], plain, ("last", (4, 3, 8))


@pytest.mark.parametrize("name", ["activation", "coupling", "transformer"])
def test_bspline_layers_invert_through_the_wrapper(name, monkeypatch):
    """BSplineActivation, BSplineCoupling and ConditionalBSplineTransformer
    each call ``bspline_inverse`` once an inverse, with the coefficients in
    their own layout (no permute copy for the coupling's net output), and
    give the plain path's values bit for bit. The layers call it through
    its module, so this one patch reaches all three."""
    run, plain, want = _layer_case(name)
    rec = _Recorder()
    monkeypatch.setattr(ob, "bspline_inverse", rec)
    with torch.no_grad():
        out = run()
        ref = plain()
    assert rec.calls == [want]
    assert torch.equal(out, ref)


# ---------------------------------------------------------------------------
# A B-spline Glow through the bridge
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bspline_glows():
    """JAX's init and data init of the reduced B-spline Glow on one batch,
    its coefficients nudged off their init, carried into the port."""
    import jax
    import jax.numpy as jnp

    from inverse_flow_tpu.layers import Flow as JaxFlow
    from inverse_flow_tpu.models.glow import build_glow as jax_build_glow
    from inverse_flow_tpu_torch.bridge import params_from_jax
    from inverse_flow_tpu_torch.models.glow import build_glow

    jflow = jax_build_glow(SIZE, **KW)
    jparams = jax.jit(lambda key: jflow.init(key, SIZE)[0])(
        jax.random.PRNGKey(0))
    rs = np.random.RandomState(7)
    x = (rs.randint(0, 256, (N,) + SIZE)
         + rs.uniform(0, 1, (N,) + SIZE)).astype(np.float32)
    jsub = JaxFlow(jflow.base_distribution, jflow.layers[1:])
    jparams = [jparams[0]] + list(jax.jit(jsub.data_init)(
        jparams[1:], jnp.asarray(x)))
    # the spline coefficients start at 0.01 N(0, 1): move them so that the
    # splines are far from the identity
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.5 * jax.random.normal(
            jax.random.PRNGKey(len(path)), v.shape)
        if "coeffs" in jax.tree_util.keystr(path) else v, jparams)
    jparams = jax.device_get(jparams)
    tflow = build_glow(SIZE, **KW, device="cpu")
    params_from_jax(tflow, jparams)
    return jflow, jsub, jparams, tflow, x


def test_bspline_glow_log_prob_matches_jax(bspline_glows):
    """log p(x) after dequantization, on the same x + u, to rtol 1e-5."""
    import jax
    import jax.numpy as jnp

    from inverse_flow_tpu_torch.layers import Flow

    jflow, jsub, jparams, tflow, x = bspline_glows
    assert sum(isinstance(m, tl.BSplineActivation)
               for m in tflow.modules()) == 2          # one per block
    _, lpj = jax.jit(jsub.forward)(jparams[1:], jnp.asarray(x))
    tsub = Flow(tflow.base_distribution, tflow.layers[1:])
    with torch.no_grad():
        _, lpt = tsub(torch.from_numpy(x))
    assert np.isfinite(lpt.numpy()).all()
    np.testing.assert_allclose(lpt.numpy(), np.asarray(lpj), rtol=1e-5)


def test_bspline_glow_sample_matches_jax(bspline_glows):
    """``Flow.sample`` of the flow after its Dequantization on JAX's own
    draws (z from the first split of the key, each SplitPrior's half from
    its layer key): to 1e-4 by norm, every B-spline inverse through the
    wrapper (the plain version on the CPU, no launch)."""
    import jax

    from inverse_flow_tpu import layers as jl
    from inverse_flow_tpu_torch.layers import Flow

    jflow, jsub, jparams, tflow, _ = bspline_glows
    rng = jax.random.PRNGKey(3)
    ref = np.asarray(jax.jit(lambda p, r: jsub.sample(p, r, N))(
        jparams[1:], rng))
    rng, base_rng = jax.random.split(rng)
    draws = {"base": jsub.base_distribution.sample(base_rng, N)[0]}
    rngs = jsub._layer_rngs(rng, salt=1)
    for i, layer in enumerate(jsub.layers):
        if isinstance(layer, jl.SplitPrior):
            draws[i] = layer.base.sample(rngs[i], N)[0]
    noise = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    before = ob.bspline_inverse.launches
    out = Flow(tflow.base_distribution, tflow.layers[1:]).sample(
        N, noise=noise)
    assert ob.bspline_inverse.launches == before
    assert out.shape == (N,) + SIZE and np.isfinite(out.numpy()).all()
    assert np.linalg.norm(out.numpy() - ref) <= 1e-4 * np.linalg.norm(ref)


# ---------------------------------------------------------------------------
# The kernel's bound in chip_smoke.py
# ---------------------------------------------------------------------------

def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("k", [5, 8])
def test_bspline_bound_counts_a_shared_set_once(k):
    """``chip_smoke.bspline_flops`` charges a shared coefficient set's
    softmax, knots and power forms once and each element only its own
    steps, and an element with its own set all of it; the power form it
    counts (a1 = (c2 - c0) s/2, a2 = (c0 + c2 - 2 c1) s/2, a3 = (3 (c1 -
    c2) + c3 - c0) s/6 on the normalized knot value, Horner's rule) gives
    the kernel's B-spline basis form's value and slope."""
    smoke = _chip_smoke()
    n = 1000
    per = smoke.BSPLINE_ELEMENT_FLOPS
    shared = smoke.bspline_flops(n, k, False)
    assert smoke.bspline_flops(2 * n, k, False) - shared == n * per
    assert shared - n * per == smoke.bspline_flops(1, k, False) - per
    assert smoke.bspline_flops(2 * n, k, True) == \
        2 * smoke.bspline_flops(n, k, True)
    assert smoke.bspline_flops(n, k, True) > n * per

    rs = np.random.RandomState(k)
    c0, c1, c2, c3 = np.cumsum(rs.uniform(0.01, 1.0, (4, 64)), 0)
    v0, s = -0.3, 1.7
    t = rs.uniform(0, 1, 64)
    basis = ((c0 * (1 - t) ** 3 + c1 * (3 * t ** 3 - 6 * t ** 2 + 4)
              + c2 * (-3 * t ** 3 + 3 * t ** 2 + 3 * t + 1) + c3 * t ** 3)
             / 6 - v0) * s
    basis_slope = ((c1 - c0) * (1 - t) ** 2
                   + (c2 - c1) * (-2 * t ** 2 + 2 * t + 1)
                   + (c3 - c2) * t ** 2) * 0.5 * s
    a0 = ((c0 + 4 * c1 + c2) / 6 - v0) * s
    a1 = (c2 - c0) * (s / 2)
    a2 = (c0 + c2 - 2 * c1) * (s / 2)
    a3 = (3 * (c1 - c2) + c3 - c0) * (s / 6)
    np.testing.assert_allclose(a0 + t * (a1 + t * (a2 + t * a3)), basis,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(a1 + t * (2 * a2 + t * 3 * a3), basis_slope,
                               rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# SmoothTanh: the kernel's exit rule on the plain loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta", [0.1, 0.01])
def test_smooth_tanh_lane_exit_lands_within_the_limit(beta):
    """On 20,001 y in [-40, 40] at alpha 1: a lane that stops at the step
    test or at the residual test |f(x) - y| <= 2^-22 max(1, |y|), keeping
    that step's x, lands within ``smooth_tanh_inverse_limit`` of the
    100-step x everywhere, after at most ``TANH_MAX_STEPS`` steps (the step
    test alone leaves elements at 100); the residual test only adds an
    exit, so no element needs more steps than by the step test."""
    y = torch.linspace(-40.0, 40.0, 20001)
    hist = tact.smooth_tanh_inverse_history(y, 1.0, beta)
    steps = tact.smooth_tanh_inverse_steps(y, 1.0, beta,
                                           tol=tact.SLR_EXIT_TOL,
                                           rule="residual")
    first = tact.smooth_tanh_inverse_steps(y, 1.0, beta,
                                           tol=tact.SLR_EXIT_TOL)
    assert int(steps.max()) <= TANH_MAX_STEPS
    assert steps.float().mean() <= 2.5
    assert (steps <= first).all() and int(first.max()) == tact.NEWTON_ITERS
    x = hist.gather(0, (steps.long() - 1)[None])[0]
    limit = tact.smooth_tanh_inverse_limit(y, hist, 1.0, beta)
    assert ((x - hist[-1]).abs() <= limit).all()
    # the lanes the residual test stops keep a residual at its rounding
    res = (tact.smooth_tanh(x, 1.0, beta) - y).abs()
    assert (res <= 4 * 2.0 ** -23 * y.abs().clamp(min=1.0)).all()


def test_smooth_tanh_steps_rules_and_variants():
    """The step rule is the default; the residual rule needs a tolerance;
    an unknown rule or variant raises; a forced variant on the CPU still
    takes the plain loop and counts no launch."""
    y = torch.linspace(-5.0, 5.0, 101)
    assert torch.equal(
        tact.smooth_tanh_inverse_steps(y, 1.0, 0.1, tol=tact.SLR_EXIT_TOL),
        tact.smooth_tanh_inverse_steps(y, 1.0, 0.1, tol=tact.SLR_EXIT_TOL,
                                       rule="step"))
    with pytest.raises(ValueError):
        tact.smooth_tanh_inverse_steps(y, 1.0, 0.1, rule="residual")
    with pytest.raises(ValueError):
        tact.smooth_tanh_inverse_steps(y, 1.0, 0.1, rule="sign")
    with pytest.raises(ValueError):
        tact.smooth_tanh_inverse(y, 1.0, 0.1, variant="fixed")
    before = dict(tact.smooth_tanh_inverse.launches_by_variant)
    assert torch.equal(
        tact.smooth_tanh_inverse(y, 1.0, 0.1, variant="step_exit"),
        tact.smooth_tanh_inverse_reference(y, 1.0, 0.1))
    assert tact.smooth_tanh_inverse.launches_by_variant == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 8])
@pytest.mark.parametrize("layout", ob.LAYOUTS)
def test_bspline_kernel_matches_plain(cuda_device, layout, k):
    """One launch a call; x within 1e-5 of the plain version (x in
    [0, 1]); the log-det within 1e-5 * max(1, max|log-det|) of the plain
    forward's at the kernel's own x; a ragged last block."""
    y, c = _operands(layout, shape=(100, 12, 16, 15), k=k, seed=1)
    y, c = y.to(cuda_device), c.to(cuda_device)
    ob.reset_bspline_launches()
    with torch.inference_mode():
        x, ld = ob.bspline_inverse(y, c, layout)
        torch.cuda.synchronize()
        x_ref, ld_ref = ob.bspline_inverse_reference(y, c, layout)
        ld_fwd = ob.monotone_cubic_b_spline(
            x, ob.last_dim_coeffs(y, c, layout))[1]
    assert ob.bspline_inverse.launches == 1
    assert (x - x_ref).abs().max().item() <= 1e-5
    assert (ld + ld_fwd).abs().max().item() <= 1e-5 * max(
        1.0, ld_ref.abs().max().item())


@pytest.mark.cuda
def test_bspline_kernel_checks(cuda_device):
    """Another dtype, autograd, more bins than the kernel takes and an
    empty input."""
    y, c = _operands("shared")
    y, c = y.to(cuda_device), c.to(cuda_device)
    with pytest.raises(TypeError):
        ob.bspline_inverse(y.double(), c.double(), "shared")
    with pytest.raises(NotImplementedError):
        ob.bspline_inverse(y, c.clone().requires_grad_(), "shared")
    big = torch.zeros(ob.BSPLINE_MAX_BINS + 4, device=cuda_device)
    with pytest.raises(ValueError):
        ob.bspline_inverse(y, big, "shared")
    x, ld = ob.bspline_inverse(y[:0], c, "shared")
    assert x.shape == ld.shape == (0,) + y.shape[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", tact.TANH_VARIANTS)
@pytest.mark.parametrize("beta", [0.1, 0.01])
def test_smooth_tanh_kernels_match_plain_loop(cuda_device, variant, beta):
    """Both SmoothTanh kernels at (100, 12, 16, 16), y in [-40, 40]: every
    element within ``smooth_tanh_inverse_limit`` of the plain loop."""
    y = (80 * torch.rand((100, 12, 16, 16), generator=torch.Generator(
        ).manual_seed(1)) - 40).to(cuda_device)
    tact.reset_smooth_tanh_launches()
    with torch.inference_mode():
        x = tact.smooth_tanh_inverse(y, 1.0, beta, variant=variant)
        torch.cuda.synchronize()
        hist = tact.smooth_tanh_inverse_history(y, 1.0, beta)
        limit = tact.smooth_tanh_inverse_limit(y, hist, 1.0, beta)
    assert tact.smooth_tanh_inverse.launches_by_variant[variant] == 1
    assert ((x - hist[-1]).abs() <= limit).all()
