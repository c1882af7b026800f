"""The Jacobi solves, their implicit VJPs and ``solver='auto'`` against the
JAX package, on the CPU.

Inputs and weights come from numpy with a seed; the same masked kernel
goes to both packages. Tolerances: values rtol 1e-5 (with atol 1e-6 for
entries near 0), gradients 1e-5 by norm (``|a - b| / |b|``). The policy
runs with the JAX package's constants patched into the port's module, so
that both route alike; the port's own constants come from the card
(``ops/solver_policy.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_flow_tpu import layers as jl
from inverse_flow_tpu.layers import Flow as JaxFlow
from inverse_flow_tpu.models.glow import build_glow as jax_build_glow
from inverse_flow_tpu.ops import inv_conv as jic
from inverse_flow_tpu.ops import solver_policy as jsp
from inverse_flow_tpu_torch import layers as tl
from inverse_flow_tpu_torch.bridge import params_from_jax
from inverse_flow_tpu_torch.layers import Flow
from inverse_flow_tpu_torch.models.glow import build_glow
from inverse_flow_tpu_torch.ops import inv_conv as tic
from inverse_flow_tpu_torch.ops import solver_policy as tsp

POLICY_CONSTANTS = ("JACOBI_LONG_MIN", "JACOBI_LONG_MAX", "JACOBI_THIN_MAX",
                    "JACOBI_KERNEL_MAX", "JACOBI_AUTO_TOL", "JACOBI_TOL_MIN")


@pytest.fixture
def jax_policy(monkeypatch):
    """The JAX package's window and tolerances in the port's policy."""
    for name in POLICY_CONSTANTS:
        monkeypatch.setattr(tsp, name, getattr(jsp, name))


def _norm_rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def _masked(w, groups):
    """The port's per-group masked kernel of raw ``w`` (numpy)."""
    layer = tl.InvFlow(w.shape[0], w.shape[2:], groups=groups, device="cpu")
    return layer._w_eff({"w": torch.from_numpy(w)}).numpy()


def _operands(chw, groups, kernel=(2, 2), scale=0.1, b=3, seed=0):
    rs = np.random.RandomState(seed)
    c = chw[0]
    w = (scale * rs.randn(c, c // groups, *kernel)).astype(np.float32)
    x = rs.randn(b, *chw).astype(np.float32)
    return x, _masked(w, groups)


def _exact(x, w_eff, groups):
    """The exact solve (JAX's blocked solve), the values a converged
    Jacobi solve must reach."""
    return np.asarray(jic.inv_conv_solve(jnp.asarray(x), jnp.asarray(w_eff),
                                         groups))


# ---------------------------------------------------------------------------
# The solves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("iters,tol", [(12, 0.0), (40, 1e-5)])
def test_jacobi_solve_matches_jax(groups, iters, tol):
    """The fixed loop and the ``tol > 0`` early exit, whose syncs the port
    counts: one per iteration run."""
    x, w_eff = _operands((4, 6, 5), groups, kernel=(3, 3))
    tic.reset_jacobi_counts()
    ours = tic.inv_conv_solve_jacobi(torch.from_numpy(x),
                                     torch.from_numpy(w_eff), groups,
                                     iters, tol).numpy()
    ref = np.asarray(jic.inv_conv_solve_jacobi(
        jnp.asarray(x), jnp.asarray(w_eff), groups, iters=iters, tol=tol))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
    syncs = tic.inv_conv_solve_jacobi.syncs
    if tol > 0:
        assert 1 <= syncs < iters        # stopped early
        np.testing.assert_allclose(ours, _exact(x, w_eff, groups),
                                   rtol=1e-4, atol=1e-5)
    else:
        assert syncs == 0


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("scale", [0.05, 0.7])
def test_guarded_solve_matches_jax(groups, scale):
    """At small weights 12 iterations pass the guard (one sync, no
    fallback); at every masked tap 0.7 (one channel a group, one column:
    ``T^{-1}`` stays bounded) they fall short, the fallback runs to the
    nilpotency cap, and the result is the exact solve."""
    chw = (groups, 16, 1)
    x, w_eff = _operands(chw, groups, scale=scale)
    if scale == 0.7:
        w_eff = _masked(np.full_like(w_eff, 0.7), groups)
    cap = chw[0] // groups * chw[1] * chw[2]
    tic.reset_jacobi_counts()
    ours = tic.inv_conv_solve_jacobi_guarded(
        torch.from_numpy(x), torch.from_numpy(w_eff), groups, 12, cap,
        1e-3).numpy()
    ref = np.asarray(jic.inv_conv_solve_jacobi_guarded(
        jnp.asarray(x), jnp.asarray(w_eff), groups, fast_iters=12,
        cap_iters=cap, tol=1e-3))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
    assert tic.inv_conv_solve_jacobi_guarded.syncs == 1
    assert tic.inv_conv_solve_jacobi_guarded.fallbacks == int(scale == 0.7)
    bare = tic.inv_conv_solve_jacobi(torch.from_numpy(x),
                                     torch.from_numpy(w_eff), groups,
                                     12).numpy()
    exact = _exact(x, w_eff, groups)
    np.testing.assert_allclose(ours, exact, rtol=1e-5, atol=1e-5)
    if scale == 0.7:
        assert np.abs(bare - exact).max() > 1e-4


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("form", ["jacobi", "jacobi_tol", "guarded",
                                  "guarded_fallback"])
def test_implicit_vjps_match_jax(form, groups):
    """dx and dW of both implicit-VJP solves against ``jax.vjp`` of the JAX
    functions, at one cotangent; the guarded backward's own guard fires
    where the forward's does."""
    chw = ((groups, 24, 1) if form == "guarded_fallback"
           else (2 * groups, 12, 3))
    x, w_eff = _operands(chw, groups, seed=1)
    if form == "guarded_fallback":
        w_eff = _masked(np.full_like(w_eff, 0.7), groups)
    gy = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    cap = chw[0] // groups * chw[1] * chw[2]
    if form.startswith("jacobi"):
        args = (groups, 30, 1e-6 if form == "jacobi_tol" else 0.0)
        jfn, tfn = (jic.inv_conv_solve_jacobi_implicit,
                    tic.inv_conv_solve_jacobi_implicit)
    else:
        args = (groups, 12, cap, 1e-3)
        jfn, tfn = (jic.inv_conv_solve_jacobi_guarded_implicit,
                    tic.inv_conv_solve_jacobi_guarded_implicit)
    y_ref, vjp = jax.vjp(lambda a, w: jfn(a, w, *args), jnp.asarray(x),
                         jnp.asarray(w_eff))
    dx_ref, dw_ref = vjp(jnp.asarray(gy))

    tic.reset_jacobi_counts()
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w_eff).requires_grad_()
    y = tfn(xt, wt, *args)
    dx, dw = torch.autograd.grad(y, [xt, wt], torch.from_numpy(gy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-6)
    assert _norm_rel(dx.numpy(), dx_ref) <= 1e-5
    assert _norm_rel(dw.numpy(), dw_ref) <= 1e-5
    if form.startswith("guarded"):
        assert tic.inv_conv_solve_jacobi_guarded.syncs == 2
        assert tic.inv_conv_solve_jacobi_guarded.fallbacks == (
            2 if form == "guarded_fallback" else 0)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_transpose_kernel_and_wgrad_groups(groups):
    """``_transpose_kernel`` and ``_solve_wgrad`` with groups against the
    JAX functions (the wgrad's JAX default runs at 'default' precision,
    one bf16 pass on a TPU and float32 on the CPU)."""
    rs = np.random.RandomState(3)
    c = 8
    w = rs.randn(c, c // groups, 2, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tic._transpose_kernel(torch.from_numpy(w), groups).numpy(),
        np.asarray(jic._transpose_kernel(jnp.asarray(w), groups)))
    y = rs.randn(3, c, 5, 4).astype(np.float32)
    dx = rs.randn(3, c, 5, 4).astype(np.float32)
    ours = tic._solve_wgrad(torch.from_numpy(y), torch.from_numpy(dx), 2, 3,
                            groups).numpy()
    ref = np.asarray(jic._solve_wgrad(jnp.asarray(y), jnp.asarray(dx), 2, 3,
                                      groups))
    assert ours.shape == (c, c // groups, 2, 3)
    assert _norm_rel(ours, ref) <= 1e-5


# ---------------------------------------------------------------------------
# The policy
# ---------------------------------------------------------------------------

POLICY_CASES = [
    # tests/test_solver_policy.py::test_resolve_auto_table
    *[((128, 1, s, s), (2, 2), 1) for s in (16, 32, 64, 128)],
    ((100, 12, 16, 16), (2, 2), 1), ((100, 4, 14, 14), (2, 2), 1),
    *[((128, 1, h, 1), (2, 2), 1) for h in (64, 128, 512, 2048, 1024, 32)],
    ((128, 1, 1, 128), (2, 2), 1), ((128, 8, 128, 1), (2, 2), 1),
    # the groups case and the kernel gate
    ((4, 8, 128, 1), (2, 2), 4), ((4, 8, 128, 1), (2, 2), 1),
    ((128, 1, 128, 1), (3, 3), 1), ((128, 1, 128, 1), (1, 2), 1),
]


@pytest.mark.parametrize("shape,kernel,groups", POLICY_CASES)
def test_policy_matches_jax(shape, kernel, groups, jax_policy):
    """``resolve_auto`` and ``auto_jacobi_params`` (its tol clamp at a
    spread of requested tols) give the JAX decisions."""
    assert tsp.resolve_auto(shape, kernel, groups) == jsp.resolve_auto(
        shape, kernel, groups)
    for iters, tol in ((12, 0.0), (12, 5e-4), (20, jsp.JACOBI_TOL_MIN),
                       (12, 1e-6)):
        assert tsp.auto_jacobi_params(shape, groups, iters, tol) == \
            jsp.auto_jacobi_params(shape, groups, iters, tol)


def test_port_window_is_tall_thin_and_two_by_two():
    """The port's own constants keep the window's shape: squares and
    production shapes exact, 3x3 kernels exact, the tolerances ordered."""
    for shape in ((128, 1, 128, 128), (100, 12, 16, 16), (100, 4, 14, 14),
                  (128, 1, 1, 4160)):
        assert tsp.resolve_auto(shape, (2, 2)) == "exact"
    for h in range(1, 5000, 37):
        assert tsp.resolve_auto((128, 1, h, 1), (3, 3)) == "exact"
        inside = tsp.JACOBI_LONG_MIN <= h <= tsp.JACOBI_LONG_MAX
        assert (tsp.resolve_auto((128, 1, h, 1), (2, 2)) == "jacobi") \
            == inside
    assert 0 < tsp.JACOBI_TOL_MIN <= tsp.JACOBI_AUTO_TOL


# ---------------------------------------------------------------------------
# The layers
# ---------------------------------------------------------------------------

TALL = (1, 128, 1)


def _layer_pair(kind, solver, scale):
    """The JAX layer and the port's, same weights: JAX's init plus
    ``scale`` x randn (or every entry ``scale`` when above 0.5)."""
    if kind == "unit":
        jlayer = jl.InvFlowUnit(1, (2, 2), solver=solver)
        tlayer = tl.InvFlowUnit(1, (2, 2), solver=solver, device="cpu")
    else:
        jcls, tcls = ((jl.InvFlowNoPad, tl.InvFlowNoPad) if kind == "no_pad"
                      else (jl.InvFlow, tl.InvFlow))
        order = {} if kind == "no_pad" else {"order": "BL"}
        jlayer = jcls(1, (2, 2), solver=solver, **order)
        tlayer = tcls(1, (2, 2), solver=solver, device="cpu", **order)
    params, _ = jlayer.init(jax.random.PRNGKey(0), TALL)
    rs = np.random.RandomState(4)
    params = jax.tree_util.tree_map(
        lambda a: (np.full(a.shape, scale, np.float32) if scale > 0.5 else
                   np.asarray(a) + scale * rs.randn(*a.shape)).astype(
                       np.float32), params)
    params_from_jax(Flow(None, [tlayer]), [params])
    return jlayer, tlayer, params


@pytest.mark.parametrize("kind", ["no_pad", "inv_flow", "unit"])
@pytest.mark.parametrize("solver", ["jacobi", "auto"])
@pytest.mark.parametrize("scale", [0.05, 0.7])
def test_layers_match_jax(kind, solver, scale, jax_policy):
    """``InvFlowNoPad``, ``InvFlow`` (BL) and ``InvFlowUnit`` at a tall
    shape inside the window: y and dW of ``sum(y * g)`` against JAX. At
    every tap 0.7 the bare 12-term ``'jacobi'`` truncation is what JAX
    computes too (both wrong alike), and ``'auto'``'s guard fires and
    gives the exact solve."""
    jlayer, tlayer, params = _layer_pair(kind, solver, scale)
    rs = np.random.RandomState(5)
    x = rs.randn(4, *TALL).astype(np.float32)
    g = rs.randn(4, *TALL).astype(np.float32)
    assert tlayer._eff_solver(x.shape) == "jacobi"

    def jloss(p):
        y, _ = jlayer.forward(p, jnp.asarray(x))
        return jnp.sum(y * g), y

    (_, y_ref), grads = jax.value_and_grad(jloss, has_aux=True)(params)
    tic.reset_jacobi_counts()
    y, ldj = tlayer(torch.from_numpy(x))
    ours = torch.autograd.grad((y * torch.from_numpy(g)).sum(),
                               list(tlayer.parameters()))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-6)
    assert torch.count_nonzero(ldj) == 0
    ref = jax.tree_util.tree_leaves(grads)
    for a, b in zip(ours, ref):
        assert _norm_rel(a.numpy(), b) <= 1e-5
    fallbacks = tic.inv_conv_solve_jacobi_guarded.fallbacks
    if solver == "auto":
        n = 4 if kind == "unit" else 1
        assert tic.inv_conv_solve_jacobi_guarded.syncs == 2 * n
        assert (fallbacks > 0) == (scale == 0.7)
        exact = (jl.InvFlowUnit(1, (2, 2), solver="exact") if kind == "unit"
                 else type(jlayer)(1, (2, 2), solver="exact",
                                   order=jlayer.order))
        y_exact, _ = exact.forward(params, jnp.asarray(x))
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_exact),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert tic.inv_conv_solve_jacobi_guarded.syncs == 0


def test_auto_outside_the_window_is_the_chain(jax_policy):
    """Outside the window ``'auto'`` is the exact chain solve, bit for
    bit, with no guard sync."""
    for kind in ("no_pad", "unit"):
        jlayer, tlayer, params = _layer_pair(kind, "auto", 0.05)
        exact = (tl.InvFlowUnit(1, (2, 2), solver="exact", device="cpu")
                 if kind == "unit" else
                 tl.InvFlowNoPad(1, (2, 2), solver="exact", device="cpu"))
        exact.load_state_dict(tlayer.state_dict())
        x = torch.from_numpy(np.random.RandomState(6).randn(
            2, 1, 16, 16).astype(np.float32))
        assert tlayer._eff_solver(x.shape) == "exact"
        tic.reset_jacobi_counts()
        assert torch.equal(tlayer(x)[0], exact(x)[0])
        assert tic.inv_conv_solve_jacobi_guarded.syncs == 0


# ---------------------------------------------------------------------------
# The three step kinds through build_glow
# ---------------------------------------------------------------------------

GLOW_SIZE = (1, 8, 4)
GLOW_KW = dict(num_blocks=1, block_size=2, coupling_width=16,
               activation="SLR")


@pytest.mark.parametrize("kind", ["inv_conv_jacobi", "inv_conv_auto",
                                  "inv_flow_unit_jacobi"])
def test_step_kinds_match_jax(kind, jax_policy):
    """A 1-block Glow of each new step kind (2x2 for the no-pad kinds, 3x3
    for the unit, as JAX's build_glow) on pre-dequantized data: log p(x)
    rtol 1e-5 and the gradients of the mean NLL 1e-5 by norm, with the
    weights carried across by ``params_from_jax``."""
    kernel = 3 if kind.startswith("inv_flow_unit") else 2
    kw = dict(GLOW_KW, step_kind=kind, if_kernel_size=kernel)
    jflow = jax_build_glow(GLOW_SIZE, **kw)
    jparams = jax.device_get(jflow.init(jax.random.PRNGKey(0),
                                        GLOW_SIZE)[0])
    tflow = build_glow(GLOW_SIZE, **kw, device="cpu")
    params_from_jax(tflow, jparams)
    rs = np.random.RandomState(7)
    x = (rs.randint(0, 256, (4,) + GLOW_SIZE)
         + rs.uniform(0.0, 1.0, (4,) + GLOW_SIZE)).astype(np.float32)
    jsub = JaxFlow(jflow.base_distribution, jflow.layers[1:])
    tsub = Flow(tflow.base_distribution, tflow.layers[1:])

    def jloss(p):
        lp = jsub.forward(p, jnp.asarray(x))[1]
        return -jnp.mean(lp), lp

    (_, lp_ref), grads = jax.value_and_grad(jloss, has_aux=True)(
        jparams[1:])
    _, lp = tsub(torch.from_numpy(x))
    names = [n for n, _ in tsub.named_parameters()]
    ours = dict(zip(names, torch.autograd.grad(-lp.mean(),
                                               list(tsub.parameters()))))
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(lp_ref),
                               rtol=1e-5)
    flat = {}
    for i, tree in enumerate(grads):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            key = ".".join(str(getattr(k, "key", getattr(k, "idx", "")))
                           for k in path)
            flat[f"layers.{i}.{key}"] = np.asarray(leaf)
    assert set(flat) == set(ours)
    for name, g in ours.items():
        if np.linalg.norm(flat[name]) > 0:
            assert _norm_rel(g.numpy(), flat[name]) <= 1e-5, name
