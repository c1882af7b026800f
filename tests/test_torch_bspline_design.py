"""The B-spline inverse kernel's design, and the layers' maps and tails in
its launch, on the CPU.

* ``bspline_newton_*_kernel`` (``csrc/bspline_inverse.cu``) emulated in
  float32 torch, its set preparation in float64 as the kernel's: the
  floored softmax by one reciprocal of its sum, the knot values in double,
  the bin's cubic in power form by Horner, Newton from the chord inside a
  bracket of the evaluated points, each lane stopping at the residual, step
  or bracket test or at the cap. Held to JAX's
  ``monotone_cubic_b_spline(..., inverse=True)`` on 20 coefficient sets x
  50,000 y: x within 1e-5 at coefficients of std 0.5 (K = 5 and 8), and on
  wide draws (std 3, where some bins sit at min_step) no farther from the
  float64 root than JAX's float32 x, plus 1e-6, with a residual under the
  float64 forward no larger than JAX's x's plus 2 ulp; no lane needs more
  than ``BSPLINE_MAX_STEPS``.
* ``bspline_inverse_reference`` with the maps and tails against JAX's
  ``BSplineActivation``, ``BSplineCoupling`` and
  ``ConditionalBSplineTransformer`` inverses, on inputs at the tail bound,
  past it and one ulp inside it: within 1e-5 of max(1, max|x|), and the
  identity, bit for bit, outside.
* ``cuda``-marked card tests of the kernel (the design against the plain
  version, the first design forced, the wide draws, the layers' inverses
  with their maps and tails, the steps it reports). They skip without a
  card. On the card: ``python -m pytest --noconftest -m cuda
  tests/test_torch_bspline_design.py``. JAX is imported inside the tests
  that use it: the card's machine has none.
"""

import numpy as np
import pytest
import torch

from inverse_flow_tpu_torch import layers as tl
from inverse_flow_tpu_torch.ops import bspline as ob

MIN_STEP = 1e-4
# csrc/bspline_inverse.cu: kStepTol and kResTol
TOL = 2.0 ** -23
SETS, PER_SET = 20, 50000


def emulate(y, coeffs, max_steps=ob.BSPLINE_MAX_STEPS):
    """(x, log-det, steps) of ``bspline_newton_*_kernel`` at ``y`` (clipped
    to [0, 1]) for raw coefficients ``coeffs`` (..., K+3) broadcastable
    against ``y[..., None]``, float32; the bin as the per-element layouts
    pick it (w_j <= w_0 + y (w_K - w_0), in double)."""
    kp3 = coeffs.shape[-1]
    k = kp3 - 3
    e = torch.exp(coeffs - coeffs.amax(-1, keepdim=True))
    step = MIN_STEP + (1.0 - kp3 * MIN_STEP) * (
        e * (1.0 / e.sum(-1, keepdim=True)))
    c = torch.cumsum(step.double(), -1)
    w = c[..., :k + 1] + 4.0 * c[..., 1:k + 2] + c[..., 2:]
    yc = ob.clip01(y)
    shape = yc.shape
    w = w.expand(shape + (k + 1,))
    step = step.expand(shape + (kp3,))
    w0, span = w[..., 0], w[..., -1] - w[..., 0]
    inv = 1.0 / span
    bin_ = (w[..., 1:k] <= (w0 + yc.double() * span)[..., None]).sum(-1)

    def pick(a, o):
        return a.gather(-1, (bin_ + o)[..., None])[..., 0]

    vn, vn1 = (pick(w, 0) - w0) * inv, (pick(w, 1) - w0) * inv
    a0_hi = vn.float()
    a0_lo = (vn - a0_hi.double()).float()
    rspan = 1.0 / (vn1 - vn).float()
    h = (3.0 * inv).float()
    e1, e2, e3 = pick(step, 1) * h, pick(step, 2) * h, pick(step, 3) * h
    b0 = (a0_hi - yc) + a0_lo
    a1, a2 = e1 + e2, e2 - e1
    a3 = ((e3 - e2) - (e2 - e1)) * (1.0 / 3.0)
    tol = TOL * b0.abs()
    t = (-b0 * rspan).clamp(0.0, 1.0)
    lo, hi = torch.full_like(t, -1.0), torch.full_like(t, 2.0)
    active = torch.ones_like(t, dtype=torch.bool)
    steps = torch.zeros_like(t, dtype=torch.int32)
    for _ in range(max_steps):
        v = a3 * t + a2
        d = a3 * t + v
        v = v * t + a1
        d = d * t + v
        r = v * t + b0
        active &= ~(r.abs() <= tol)
        lo = torch.where(active & (r < 0), t, lo)
        hi = torch.where(active & (r >= 0), t, hi)
        newton = d > 0
        tn = (t - r * (1.0 / d)).clamp(0.0, 1.0)
        small = newton & ((tn - t).abs() <= TOL)
        inside = newton & (lo < tn) & (tn < hi)
        mid = 0.5 * (lo.clamp_min(0.0) + hi.clamp_max(1.0))
        t = torch.where(active, torch.where(small | inside, tn, mid), t)
        steps += active.int()
        active &= ~small & ~((hi - lo) <= TOL)
        if not active.any():
            break
    omt = 1.0 - t
    slope = k * (e1 * omt * omt + e2 * (2.0 * t * omt + 1.0)
                 + e3 * t * t)
    return ((bin_ + t) * (1.0 / k), -torch.log(slope.clamp_min(1e-12)),
            steps)


def _draws(k, std, seed, sets=SETS, per_set=PER_SET):
    """y uniform in [0, 1] (sets, per_set) and one coefficient set a row
    (sets, 1, K+3) at ``std``."""
    rs = np.random.RandomState(seed)
    c = (std * rs.randn(sets, 1, k + 3)).astype(np.float32)
    y = rs.uniform(0, 1, (sets, per_set)).astype(np.float32)
    return torch.from_numpy(y), torch.from_numpy(c)


def _jax_spline(y, c, inverse):
    import jax.numpy as jnp

    from inverse_flow_tpu.layers import splines as jsplines

    out, ld = jsplines.monotone_cubic_b_spline(
        jnp.asarray(y.numpy()), jnp.asarray(c.numpy()), inverse=inverse)
    return (torch.from_numpy(np.array(out)), torch.from_numpy(np.array(ld)))


@pytest.mark.parametrize("k", [5, 8])
def test_design_matches_jax_at_todays_draws(k):
    """Coefficients at std 0.5: x within 1e-5 of JAX's inverse; the log-det
    within 1e-5 * max(1, max|log-det|) of JAX's forward log-det at the
    emulated x; every lane done within ``BSPLINE_MAX_STEPS`` (run with a
    cap of 64), about 2 steps on average."""
    y, c = _draws(k, 0.5, seed=k)
    x, ld, steps = emulate(y, c, max_steps=64)
    xj, ldj = _jax_spline(y, c, inverse=True)
    assert (x - xj).abs().max().item() <= 1e-5
    ld_fwd = _jax_spline(x, c, inverse=False)[1]
    assert (ld + ld_fwd).abs().max().item() <= 1e-5 * max(
        1.0, ldj.abs().max().item())
    assert int(steps.max()) <= ob.BSPLINE_MAX_STEPS
    assert steps.float().mean().item() <= 2.5


def residual64(x, y, coeffs):
    """max |f(x) - y| of the plain forward in float64 (the spline itself,
    not its float32 rounding, which on a set whose knots span 1e-3 is
    already about 1e-4 of y and favours the plain inverse's x, found on
    that same rounding)."""
    return (ob.monotone_cubic_b_spline(x.double(), coeffs.double())[0]
            - y.double()).abs().max().item()


@pytest.mark.parametrize("sets", ["rows", "own"])
@pytest.mark.parametrize("k", [5, 8])
def test_design_on_wide_draws(k, sets):
    """Coefficients at std 3 (some bins at min_step, the root
    ill-conditioned), one set a row of 50,000 y or each of 200,000 y its
    own: the emulated x no farther from the float64 plain inverse than
    JAX's float32 x is, plus 1e-6; the float64 forward at it returns y to
    within JAX's x's residual plus 2 ulp of 1; every lane done within
    ``BSPLINE_MAX_STEPS`` (run with a cap of 64)."""
    if sets == "rows":
        y, c = _draws(k, 3.0, seed=10 + k)
    else:
        y, c = _draws(k, 3.0, seed=20 + k, sets=200000, per_set=1)
        y = y[:, 0]
        c = c[:, 0]
    x, _, steps = emulate(y, c, max_steps=64)
    xj, _ = _jax_spline(y, c, inverse=True)
    x64, _ = ob.monotone_cubic_b_spline(y.double(), c.double(), inverse=True)
    err = (x.double() - x64).abs().max().item()
    err_j = (xj.double() - x64).abs().max().item()
    assert err <= err_j + 1e-6, (err, err_j)
    res, res_j = residual64(x, y, c), residual64(xj, y, c)
    assert res <= res_j + 2 * 2.0 ** -23, (res, res_j)
    assert int(steps.max()) <= ob.BSPLINE_MAX_STEPS


def test_design_cap_holds_every_lane():
    """At the kernel's own cap, the lanes that it would stop early are
    none: the emulation with cap ``BSPLINE_MAX_STEPS`` gives the same x as
    with a cap of 64, on the wide draws at 8 bins."""
    y, c = _draws(8, 3.0, seed=3, sets=8, per_set=20000)
    x, _, steps = emulate(y, c)
    x_long, _, steps_long = emulate(y, c, max_steps=64)
    assert torch.equal(steps, steps_long)
    assert torch.equal(x, x_long)


# ---------------------------------------------------------------------------
# The layers' maps and tails, on the plain version
# ---------------------------------------------------------------------------

def _edge_inputs(shape, tb, seed):
    """3 N(0, 1) draws with, at fixed places, the tail bound, past it, and
    one ulp inside it, both signs."""
    x = (3.0 * np.random.RandomState(seed).randn(*shape)).astype(np.float32)
    flat = x.reshape(-1)
    inside = np.nextafter(np.float32(tb), np.float32(0))
    edges = np.array([tb, -tb, inside, -inside, tb + 1e-3, -tb - 1e-3,
                      2 * tb, -2 * tb, 0.0], np.float32)
    flat[:len(edges)] = edges
    return x


def _jax_pair(name, tb):
    import jax

    from inverse_flow_tpu import layers as jl
    from inverse_flow_tpu_torch.bridge import params_from_jax

    if name == "activation":
        jlayer = jl.BSplineActivation(n_bins=5, tail_bound=tb)
        tlayer = tl.BSplineActivation(n_bins=5, tail_bound=tb)
    else:
        jlayer = jl.BSplineCoupling((4, 6, 6), width=16, n_bins=5,
                                    tail_bound=tb)
        tlayer = tl.BSplineCoupling((4, 6, 6), width=16, n_bins=5,
                                    tail_bound=tb)
    params, _ = jlayer.init(jax.random.PRNGKey(0), (4, 6, 6))
    leaves, tree = jax.tree_util.tree_flatten(params)
    # the activation's coefficients at std 0.5; the coupling's weights
    # nudged by 0.05 (its zero-initialized last conv too), which gives
    # coefficients of about that size
    rs = np.random.RandomState(1)
    scale = 0.5 if name == "activation" else 0.05
    params = jax.tree_util.tree_unflatten(tree, [
        np.asarray(v) + scale * rs.randn(*np.shape(v)).astype(np.float32)
        for v in leaves])
    params_from_jax(tl.Flow(None, [tlayer]), [params])
    return jlayer, tlayer, params


@pytest.mark.parametrize("name", ["activation", "coupling"])
def test_layer_inverse_with_tails_matches_jax(name):
    """The layer's inverse (the plain version with the maps and tails on
    the CPU) against JAX's, on inputs at, past and one ulp inside the tail
    bound: within 1e-5 * max(1, max|x|), and y itself wherever |y| >= the
    bound."""
    import jax
    import jax.numpy as jnp

    tb = 6.0
    jlayer, tlayer, params = _jax_pair(name, tb)
    z = _edge_inputs((4, 4, 6, 6), tb, seed=2)
    xj = np.asarray(jax.jit(jlayer.inverse)(params, jnp.asarray(z)))
    with torch.no_grad():
        xt = tlayer.inverse(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(xt, xj, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(xj).max()))
    half = z if name == "activation" else z[:, 2:]
    out = xt if name == "activation" else xt[:, 2:]
    outside = np.abs(half) >= tb
    assert outside.sum() >= 6
    assert np.array_equal(out[outside], half[outside])
    if name == "coupling":
        assert np.array_equal(xt[:, :2], z[:, :2])


def test_transformer_inverse_with_maps_matches_jax():
    """ConditionalBSplineTransformer on [-2, 3) -> [0, 5): the inverse and
    its log-det against JAX's, on z at the interval's ends and past them
    (clipped, no tails)."""
    import jax.numpy as jnp

    from inverse_flow_tpu.layers import splines as jsplines

    rs = np.random.RandomState(5)
    net = (0.5 * rs.randn(4, 6 * 11)).astype(np.float32)
    z = rs.uniform(0, 5, (4, 6)).astype(np.float32)
    z[0] = [0.0, 5.0, -1.0, 6.0, np.nextafter(np.float32(5), 0), 1e-7]
    jt = jsplines.ConditionalBSplineTransformer(6, n_bins=8, left=-2.0,
                                                right=3.0, bottom=0.0,
                                                top=5.0)
    tt = tl.ConditionalBSplineTransformer(6, n_bins=8, left=-2.0, right=3.0,
                                          bottom=0.0, top=5.0)
    yj, lj = jt.inverse(jnp.asarray(net), jnp.asarray(z))
    yt, lt = tt.inverse(torch.from_numpy(net), torch.from_numpy(z))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=1e-5 * max(1.0, np.abs(yj).max()))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=1e-5 * max(1.0, np.abs(lj).max()))


def test_reference_extras_default_to_the_bare_spline():
    """Without extras the plain version is today's bare inverse bit for
    bit; with an interval of (0, 1) and the out interval (0, 1) too; the
    log-det is None when not asked for; tails need an interval."""
    y, c = _draws(5, 0.5, seed=0, sets=3, per_set=100)
    c = c[:, 0][:, None].expand(3, 100, 8)
    x, ld = ob.bspline_inverse_reference(y, c, "last")
    x_ref, ld_ref = ob.monotone_cubic_b_spline(y, c, inverse=True)
    assert torch.equal(x, x_ref) and torch.equal(ld, ld_ref)
    x2, ld2 = ob.bspline_inverse_reference(y, c, "last", interval=(0.0, 1.0),
                                           out_interval=(0.0, 1.0))
    assert torch.equal(x2, x_ref) and torch.equal(ld2, ld_ref)
    x3, none = ob.bspline_inverse(y, c, "last", logdet=False)
    assert none is None and torch.equal(x3, x_ref)
    with pytest.raises(ValueError):
        ob.bspline_inverse_reference(y, c, "last", tails=True)


def test_wrapper_extras_checks():
    """Tails without an interval, an unknown variant and steps on the CPU
    raise; the first design forced on the CPU is the plain version and
    counts no launch."""
    y, c = _draws(5, 0.5, seed=1, sets=2, per_set=10)
    c = c[0, 0]
    with pytest.raises(ValueError):
        ob.bspline_inverse(y, c, "shared", tails=True)
    with pytest.raises(ValueError):
        ob.bspline_inverse(y, c, "shared", variant="bisect")
    with pytest.raises(ValueError):
        ob.bspline_inverse(y, c, "shared", steps=True)
    before = dict(ob.bspline_inverse.launches_by_variant)
    x, ld = ob.bspline_inverse(y, c, "shared", variant="first")
    x_ref, ld_ref = ob.bspline_inverse_reference(y, c, "shared")
    assert torch.equal(x, x_ref) and torch.equal(ld, ld_ref)
    assert ob.bspline_inverse.launches_by_variant == before
    assert set(before) == set(ob.BSPLINE_VARIANTS)


def test_y_strides_read_a_channel_slice_in_place():
    """A coupling's second half (a channel slice of a contiguous tensor) is
    read where it lies, as rows of C2*H*W at a stride of C*H*W; a
    contiguous y as one row; any other layout is copied first (None)."""
    z = torch.zeros(3, 5, 4, 6)
    assert ob._y_strides(z[:, 2:]) == (3 * 4 * 6, 5 * 4 * 6)
    assert ob._y_strides(z) == (z.numel(), z.numel())
    assert ob._y_strides(z.transpose(2, 3)) is None
    assert ob._y_strides(z[:, :, 1:]) is None


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


def _operands(layout, shape, k, std, seed, device):
    rs = np.random.RandomState(seed)
    y = rs.uniform(0, 1, shape).astype(np.float32)
    if layout == "shared":
        c = rs.randn(k + 3)
    elif layout == "channels":
        c = rs.randn(shape[0], shape[1] * (k + 3), *shape[2:])
    else:
        c = rs.randn(*shape, k + 3)
    return (torch.from_numpy(y).to(device),
            torch.from_numpy((std * c).astype(np.float32)).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ob.LAYOUTS)
def test_first_design_forced_matches_plain(cuda_device, layout):
    """The first design, forced: one launch of it and none of the new
    kernel, x within 1e-5 of the plain version."""
    y, c = _operands(layout, (100, 6, 16, 15), 8, 0.5, 2, cuda_device)
    ob.reset_bspline_launches()
    with torch.inference_mode():
        x, _ = ob.bspline_inverse(y, c, layout, variant="first")
        torch.cuda.synchronize()
        x_ref, _ = ob.bspline_inverse_reference(y, c, layout)
    assert ob.bspline_inverse.launches_by_variant == {"bracketed": 0,
                                                      "first": 1}
    assert (x - x_ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 8])
@pytest.mark.parametrize("layout", ob.LAYOUTS)
def test_kernel_on_wide_draws(cuda_device, layout, k):
    """Coefficients at std 3 at (100, 12, 16, 16): x no farther from the
    float64 plain inverse than the float32 plain version is, plus 1e-6;
    the float64 forward at it returns y to within the float32 plain
    inverse's residual plus 2 ulp of 1; every lane within the cap."""
    y, c = _operands(layout, (100, 12, 16, 16), k, 3.0, 3, cuda_device)
    with torch.inference_mode():
        x, _, steps = ob.bspline_inverse(y, c, layout, steps=True)
        last = ob.last_dim_coeffs(y, c, layout)
        x32, _ = ob.monotone_cubic_b_spline(y, last, inverse=True)
        x64, _ = ob.monotone_cubic_b_spline(y.double(), last.double(),
                                            inverse=True)
        res, res32 = residual64(x, y, last), residual64(x32, y, last)
    err = (x.double() - x64).abs().max().item()
    err32 = (x32.double() - x64).abs().max().item()
    assert err <= err32 + 1e-6, (err, err32)
    assert res <= res32 + 2 * 2.0 ** -23, (res, res32)
    assert int(steps.max()) <= ob.BSPLINE_MAX_STEPS


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["activation", "coupling", "transformer"])
def test_layer_inverses_on_the_kernel(cuda_device, name):
    """Each B-spline layer's inverse: one launch, within 1e-5 * max(1,
    max|x|) of the same layer on the plain version, on inputs at, past
    and one ulp inside the tail bound; the identity outside, bit for bit."""
    from unittest import mock

    tb = 6.0
    gen = torch.Generator(cuda_device).manual_seed(0)
    if name == "transformer":
        layer = tl.ConditionalBSplineTransformer(6, n_bins=8, left=-2.0,
                                                 right=3.0, bottom=0.0,
                                                 top=5.0)
        net = 0.5 * torch.randn((64, 66), generator=gen, device=cuda_device)
        z = 5 * torch.rand((64, 6), generator=gen, device=cuda_device)
        z[0] = torch.tensor([0.0, 5.0, -1.0, 6.0, 4.9999995, 1e-7])

        def run():
            return layer.inverse(net, z)[0]
    else:
        if name == "activation":
            layer = tl.BSplineActivation(n_bins=5, tail_bound=tb,
                                         generator=gen, device=cuda_device)
            param = layer.coeffs
        else:
            layer = tl.BSplineCoupling((4, 16, 16), width=32, n_bins=5,
                                       tail_bound=tb, generator=gen,
                                       device=cuda_device)
            param = layer.w3
        # the activation's coefficients at std 0.5; the coupling's
        # zero-initialized last conv at 0.01, as chip_smoke.py draws it
        # (at 0.5 its coefficients reach std 8: wide draws, where the
        # plain version's own float32 error passes 1e-5)
        with torch.no_grad():
            param.copy_((0.5 if name == "activation" else 0.01) * torch.randn(
                param.shape, generator=gen, device=cuda_device))
        z = torch.from_numpy(_edge_inputs((64, 4, 16, 16), tb, 4)).to(
            cuda_device)

        def run():
            return layer.inverse(z)
    ob.reset_bspline_launches()
    with torch.inference_mode():
        x = run()
        torch.cuda.synchronize()
        launches = ob.bspline_inverse.launches
        with mock.patch.object(ob, "bspline_inverse",
                               ob.bspline_inverse_reference):
            x_ref = run()
    assert launches == 1
    assert (x - x_ref).abs().max().item() <= 1e-5 * max(
        1.0, x_ref.abs().max().item())
    if name != "transformer":
        half = z if name == "activation" else z[:, 2:]
        out = x if name == "activation" else x[:, 2:]
        outside = half.abs() >= tb
        assert torch.equal(out[outside], half[outside])


@pytest.mark.cuda
def test_kernel_steps_and_logdet_options(cuda_device):
    """Asking for the steps or dropping the log-det does not move x; the
    steps lie in [0, cap], about 2 on average at std 0.5."""
    y, c = _operands("shared", (100, 12, 16, 16), 8, 0.5, 5, cuda_device)
    with torch.inference_mode():
        x, ld = ob.bspline_inverse(y, c, "shared")
        x2, none = ob.bspline_inverse(y, c, "shared", logdet=False)
        x3, ld3, steps = ob.bspline_inverse(y, c, "shared", steps=True)
    assert none is None
    assert torch.equal(x, x2) and torch.equal(x, x3) and torch.equal(ld, ld3)
    assert steps.dtype == torch.int32 and int(steps.min()) >= 0
    assert int(steps.max()) <= ob.BSPLINE_MAX_STEPS
    assert steps.float().mean().item() <= 3.0
