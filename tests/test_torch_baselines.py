"""The paper's comparison baselines against the JAX package, on the CPU:
Glow's 1x1 conv and its Householder form, the operator build on a
non-unit diagonal, Emerging (its inverse on the chain's plain version),
the CNN and FC builders on the registry's models, the exact-correction
identity on the Conv1x1 and Emerging flows, the bridge on Emerging's
parameterless list entry, and ``InvFlow(solver='fused')``.

Inputs come from numpy with a seed; weights cross with ``params_from_jax``.
On a CPU tensor the port's chain runs its plain version; the JAX
Emerging inverse is its XLA solve (``inv_conv_solve``).

Tolerances: channel mixes and masked convs rtol 1e-5 (atol 1e-5); ldj
rtol 1e-5; inverses and round trips rel 1e-4 by norm (float32 solves);
the triangular inverse ``M0 X = I`` within 1e-5 and against JAX rel 1e-5
by norm; log p of the models rtol 1e-5, their gradients rel 1e-4 by
norm; exact = cheap + correction rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_flow_tpu.layers import Flow as JaxFlow
from inverse_flow_tpu.layers import conv1x1 as jc1
from inverse_flow_tpu.layers import emerging as jem
from inverse_flow_tpu.models import glow as jglow
from inverse_flow_tpu.ops import inv_conv as jic
from inverse_flow_tpu_torch import layers as tl
from inverse_flow_tpu_torch.bridge import params_from_jax, params_to_jax
from inverse_flow_tpu_torch.experiments import registry as tregistry
from inverse_flow_tpu_torch.layers import Flow
from inverse_flow_tpu_torch.layers import conv1x1 as tc1
from inverse_flow_tpu_torch.layers import emerging as tem
from inverse_flow_tpu_torch.models import glow as tglow
from inverse_flow_tpu_torch.ops import fused_chain as tfc
from inverse_flow_tpu_torch.ops import inv_conv as tic

from test_torch_sample import _jax_draws
from test_torch_selfnorm import _grad_tree


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _load(tlayer, jparams):
    params_from_jax(Flow(None, [tlayer]), [jparams])


# ---------------------------------------------------------------------------
# Conv1x1 and Conv1x1Householder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["conv1x1", "householder"])
def test_conv1x1_layers_match_jax(kind):
    """Values, ldj (H*W*slogdet(W), 0 for Householder) and the inverse,
    with W off orthogonal so that the ldj is far from 0."""
    rs = np.random.RandomState(1)
    if kind == "conv1x1":
        jlayer, tlayer = jc1.Conv1x1(6), tc1.Conv1x1(6)
    else:
        jlayer, tlayer = (jc1.Conv1x1Householder(6, 4),
                          tc1.Conv1x1Householder(6, 4))
    jparams, _ = jlayer.init(jax.random.PRNGKey(0), (6, 5, 7))
    jparams = {k: np.asarray(v) + 0.3 * rs.randn(*v.shape).astype(
        np.float32) for k, v in jparams.items()}
    _load(tlayer, jparams)
    x = rs.randn(3, 6, 5, 7).astype(np.float32)
    z, ldj = tlayer(_t(x))
    z_ref, ldj_ref = jlayer.forward(jparams, x)
    np.testing.assert_allclose(z.detach().numpy(), z_ref, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ldj.detach().numpy(), ldj_ref, rtol=1e-5)
    assert (kind == "householder") == (not np.any(ldj_ref))
    back = tlayer.inverse(z.detach()).detach().numpy()
    assert _rel(back, jlayer.inverse(jparams, z_ref)) <= 1e-4
    assert _rel(back, x) <= 1e-4
    assert not tlayer.has_exact_path


def test_conv1x1_init_is_orthogonal():
    layer = tc1.Conv1x1(8, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    w = layer.W.detach()
    torch.testing.assert_close(w.T @ w, torch.eye(8), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# The operator build on a non-unit diagonal
# ---------------------------------------------------------------------------

def _tri_stack(kind, n=24, count=3, seed=2):
    """Elementwise-triangular (count, n, n) stacks: unit lower (a masked
    kernel's M0), unit upper (its transpose's), and lower with a diagonal
    drawn in [0.5, 2] (an Emerging kernel's)."""
    rs = np.random.RandomState(seed)
    m = 0.3 * rs.randn(count, n, n).astype(np.float32)
    m = np.tril(m, -1) if kind != "upper" else np.triu(m, 1)
    diag = (rs.uniform(0.5, 2.0, (count, n)) if kind == "nonunit"
            else np.ones((count, n)))
    return (m + diag[:, :, None] * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("kind", ["lower", "upper", "nonunit"])
def test_tri_inverse_takes_a_non_unit_diagonal(kind):
    m0 = _tri_stack(kind)
    x = tic._tri_inverse(_t(m0)).numpy()
    eye = np.eye(m0.shape[-1])
    assert np.abs(m0 @ x - eye).max() <= 1e-5
    ref = np.stack([np.asarray(jic._tri_inverse(m)) for m in m0])
    assert _rel(x, ref) <= 1e-5


# ---------------------------------------------------------------------------
# Emerging
# ---------------------------------------------------------------------------

EMERGING_SHAPES = [(1, 28, 28), (4, 14, 14)]


def _ar_params(c, seed):
    """An AR conv's params with its diagonal drawn in [0.5, 2] (signs
    mixed) and taps of std 0.2 / C."""
    rs = np.random.RandomState(seed)
    w = (0.2 / c * rs.randn(c, c, 2, 2)).astype(np.float32)
    diag = rs.uniform(0.5, 2.0, c) * rs.choice([-1.0, 1.0], c)
    w[np.arange(c), np.arange(c), -1, -1] = diag
    return {"w": w, "b": (0.1 * rs.randn(c)).astype(np.float32)}


@pytest.mark.parametrize("chw", EMERGING_SHAPES, ids=["1x28x28", "4x14x14"])
def test_ar_conv_inverse_on_the_plain_chain_matches_jax(chw):
    """The AR conv's forward, ldj and inverse: the port's inverse is the
    chain's plain version (no launch on the CPU), JAX's ``inv_conv_solve``
    on the same non-unit operator."""
    c = chw[0]
    jlayer = jem.SquareAutoRegressiveConv2d(c)
    tlayer = tem.SquareAutoRegressiveConv2d(c)
    jparams = _ar_params(c, seed=c)
    _load(tlayer, jparams)
    x = np.random.RandomState(3).randn(4, *chw).astype(np.float32)
    z, ldj = tlayer(_t(x))
    z_ref, ldj_ref = jlayer.forward(jparams, x)
    np.testing.assert_allclose(z.detach().numpy(), z_ref, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ldj.detach().numpy(), ldj_ref, rtol=1e-5)
    before = tfc.chain_phases.launches
    with torch.no_grad():
        back = tlayer.inverse(z)
        args = tfc.chain_inputs(z - tlayer.b.reshape(1, -1, 1, 1),
                                (tlayer._w_eff(tlayer.own_params()),),
                                ("TL",))
        plain = tfc._from_blocks_trim(
            tfc.chain_phases_reference(*args)[-1], *chw)
    assert tfc.chain_phases.launches == before
    ref = np.asarray(jlayer.inverse(jparams, z_ref))
    assert _rel(back.numpy(), ref) <= 1e-4
    assert _rel(back.numpy(), x) <= 1e-4
    np.testing.assert_array_equal(plain.numpy(), back.numpy())


def test_emerging_layer_matches_jax():
    """The whole layer (1x1, AR, flip, AR, flip): params ``t.0.W``,
    ``t.1.w`` ... as the JAX tree with its flips' empty entries; forward,
    ldj and inverse against JAX."""
    c, chw = 4, (4, 14, 14)
    jlayer, tlayer = jem.Emerging(c), tem.Emerging(c)
    jparams, _ = jlayer.init(jax.random.PRNGKey(1), chw)
    jparams = {"t": [jparams["t"][0], _ar_params(c, 5), {},
                     _ar_params(c, 6), {}]}
    _load(tlayer, jparams)
    assert sorted(dict(tlayer.named_parameters())) == [
        "t.0.W", "t.1.b", "t.1.w", "t.3.b", "t.3.w"]
    back_tree = params_to_jax(Flow(None, [tlayer]))[0]
    assert (jax.tree_util.tree_structure(back_tree)
            == jax.tree_util.tree_structure(jparams))
    x = np.random.RandomState(4).randn(3, *chw).astype(np.float32)
    z, ldj = tlayer(_t(x))
    z_ref, ldj_ref = jlayer.forward(jparams, x)
    np.testing.assert_allclose(z.detach().numpy(), z_ref, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ldj.detach().numpy(), ldj_ref, rtol=1e-5)
    with torch.no_grad():
        back = tlayer.inverse(z).numpy()
    assert _rel(back, jlayer.inverse(jparams, z_ref)) <= 1e-4
    assert _rel(back, x) <= 1e-4


def test_square_ar_mask_matches_jax():
    np.testing.assert_array_equal(tem.square_ar_mask(5).numpy(),
                                  np.asarray(jem.square_ar_mask(5)))


# ---------------------------------------------------------------------------
# The CNN and FC builders on the registry's models
# ---------------------------------------------------------------------------

# each registry model's builder arguments, cut to a few layers where it is
# deep (the widths and shapes are the registry's)
MODELS = {
    "if_cnn_mnist": ("cnn", dict(step_kind="inv_conv_no_pad", num_blocks=3,
                                 block_size=1, activation="Spline",
                                 n_bins=10, tail_bound=30.0, kernel=(2, 2))),
    "exact_cnn_mnist": ("cnn", dict(step_kind="inv_conv_no_pad",
                                    num_blocks=3, block_size=1,
                                    activation="Spline", kernel=(3, 3))),
    "selfnorm_cnn_mnist": ("cnn", dict(step_kind="snf_cnn", num_blocks=3,
                                       block_size=1, activation="Spline")),
    "emerging_cnn_mnist": ("cnn", dict(step_kind="emerging", num_blocks=2,
                                       block_size=1, activation="Spline",
                                       n_bins=10, tail_bound=70.0)),
    "exact_fc_mnist": ("fc", dict(num_layers=2, kind="inv_conv_no_pad",
                                  activation="Spline", tail_bound=10.0)),
    "selfnorm_fc_mnist": ("fc", dict(num_layers=2, kind="snf_fc",
                                     activation="Spline", tail_bound=10.0)),
    "conv1x1_glow_mnist": ("glow", dict(step_kind="conv1x1", num_blocks=2,
                                        block_size=2, coupling_width=16,
                                        activation="None")),
    "if_conv1x1_glow_mnist": ("glow", dict(step_kind="inv_conv",
                                           num_blocks=2, block_size=2,
                                           coupling_width=16)),
}
BUILDERS = {"cnn": "build_cnn_flow", "fc": "build_fc_flow",
            "glow": "build_glow"}
SIZE = (1, 28, 28)
B = 4


def _model_pair(name, seed=0):
    """The JAX model and the port's with JAX's params (from ``seed``;
    spline knots and every weight moved by 0.05 noise), and raw data with
    its dequantization noise."""
    family, kw = MODELS[name]
    jflow = getattr(jglow, BUILDERS[family])(SIZE, **kw)
    tflow = getattr(tglow, BUILDERS[family])(SIZE, **kw, device="cpu")
    init = lambda k: jflow.init(k, SIZE)[0]     # noqa: E731
    # Conv1x1's init takes its QR in numpy: it cannot be traced
    eager = kw.get("step_kind") in ("conv1x1", "emerging")
    jparams = jax.device_get((init if eager else jax.jit(init))(
        jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 1)
    jparams = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rs.randn(*a.shape).astype(np.float32),
        jparams)
    params_from_jax(tflow, jparams)
    x = rs.randint(0, 256, (B,) + SIZE).astype(np.float32)
    u = rs.uniform(0.0, 1.0, (B,) + SIZE).astype(np.float32)
    return jflow, jparams, tflow, x, u


def _sub(flow, cls):
    return cls(flow.base_distribution, flow.layers[1:])


@pytest.mark.parametrize("name", list(MODELS))
def test_builders_match_jax(name):
    """Layer types in order, and log p (cheap and exact) on the same
    dequantized batch; exact = cheap + correction."""
    jflow, jparams, tflow, x, u = _model_pair(name)
    assert [type(l).__name__ for l in tflow.layers] == [
        type(l).__name__ for l in jflow.layers]
    assert tuple(tflow.base_distribution.size) == tuple(
        jflow.base_distribution.size)
    jsub, tsub = _sub(jflow, JaxFlow), _sub(tflow, Flow)
    y = x + u
    with torch.no_grad():
        cheap = tsub(_t(y))[1].numpy()
        exact = tsub(_t(y), exact=True)[1].numpy()
        corr = float(tsub.exact_ldj_correction(SIZE))
    has_exact = any(l.has_exact_path for l in tflow.layers)
    assert has_exact == name.startswith("selfnorm")
    assert (corr != 0.0) == has_exact
    ref = jax.jit(lambda p, v: jsub.forward(p, v)[1])(jparams[1:], y)
    np.testing.assert_allclose(cheap, ref, rtol=1e-5)
    np.testing.assert_allclose(exact, cheap + corr, rtol=1e-5)
    if has_exact:       # else JAX's exact path is its cheap one too
        ref = jax.jit(lambda p, v: jsub.forward(p, v, exact=True)[1])(
            jparams[1:], y)
    np.testing.assert_allclose(exact, ref, rtol=1e-5)


@pytest.mark.parametrize("name", ["emerging_cnn_mnist", "exact_fc_mnist",
                                  "conv1x1_glow_mnist"])
def test_builder_gradients_match_jax(name):
    """-log p(x) on the exact path (these configs train with
    ``modified_grad=False``): every leaf's gradient against ``jax.grad``."""
    jflow, jparams, tflow, x, u = _model_pair(name)
    jsub, tsub = _sub(jflow, JaxFlow), _sub(tflow, Flow)
    y = x + u
    refs = jax.jit(jax.grad(lambda p: -jnp.mean(
        jsub.forward(p, y, exact=True)[1])))(jparams[1:])
    (-tsub(_t(y), exact=True)[1].mean()).backward()
    back = _grad_tree(tsub)
    for (path, ref), a in zip(jax.tree_util.tree_leaves_with_path(refs),
                              jax.tree_util.tree_leaves(back)):
        assert _rel(a, ref) <= 1e-4, path


def test_emerging_flow_sample_matches_jax():
    """``Flow.sample`` of the reduced ``emerging_cnn_mnist`` on JAX's
    draws: every AR conv's inverse on the plain chain against JAX's
    solves."""
    jflow, jparams, tflow, _, _ = _model_pair("emerging_cnn_mnist")
    jsub, tsub = _sub(jflow, JaxFlow), _sub(tflow, Flow)
    rng = jax.random.PRNGKey(3)
    ref = np.asarray(jax.jit(lambda p, r: jsub.sample(p, r, B))(
        jparams[1:], rng))
    ours = tsub.sample(B, noise=_jax_draws(jsub, rng, B)).numpy()
    assert np.isfinite(ours).all()
    assert _rel(ours, ref) <= 1e-4


def test_emerging_model_round_trips_through_the_bridge():
    """The registry's ``emerging_cnn_mnist`` at full depth: its params
    through ``params_to_jax`` keep every Emerging's five entries (the last
    flip's empty one too), and JAX's log p on them equals the port's."""
    tflow = tregistry.get_experiment("emerging_cnn_mnist").build_model(
        device="cpu", generator=torch.Generator().manual_seed(0))
    jflow = jglow.build_cnn_flow(SIZE, step_kind="emerging", num_blocks=2,
                                 block_size=4, activation="Spline",
                                 n_bins=10, tail_bound=70.0)
    back = params_to_jax(tflow)
    # eagerly: Conv1x1's init takes its QR in numpy
    jparams = jflow.init(jax.random.PRNGKey(0), SIZE)[0]
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jparams))
    emerging = [p for l, p in zip(tflow.layers, back)
                if isinstance(l, tem.Emerging)]
    assert len(emerging) == 8 and all(len(p["t"]) == 5 and p["t"][4] == {}
                                      for p in emerging)
    rs = np.random.RandomState(8)
    y = (rs.randint(0, 256, (B,) + SIZE)
         + rs.uniform(0.0, 1.0, (B,) + SIZE)).astype(np.float32)
    jsub, tsub = _sub(jflow, JaxFlow), _sub(tflow, Flow)
    with torch.no_grad():
        ours = tsub(_t(y))[1].numpy()
    ref = jax.jit(lambda p, v: jsub.forward(p, v)[1])(back[1:], y)
    np.testing.assert_allclose(ours, ref, rtol=1e-5)


# ---------------------------------------------------------------------------
# InvFlow's solver names
# ---------------------------------------------------------------------------

def test_inv_flow_fused_is_the_exact_solve():
    gen = torch.Generator().manual_seed(2)
    exact = tl.InvFlow(4, (3, 3), solver="exact", generator=gen,
                       device="cpu")
    fused = tl.InvFlow(4, (3, 3), solver="fused", device="cpu")
    fused.load_state_dict(exact.state_dict())
    x = torch.randn((2, 4, 6, 6), generator=gen)
    torch.testing.assert_close(fused(x)[0], exact(x)[0], rtol=0, atol=0)
    # 'auto' outside the Jacobi window (a 3x3 kernel) is the same solve;
    # 'jacobi' is ported (tests/test_torch_jacobi.py holds it to JAX)
    auto = tl.InvFlow(4, (3, 3), solver="auto", device="cpu")
    auto.load_state_dict(exact.state_dict())
    assert auto._eff_solver(x.shape) == "exact"
    torch.testing.assert_close(auto(x)[0], exact(x)[0], rtol=0, atol=0)
    assert tl.InvFlow(4, (3, 3), solver="jacobi")._eff_solver(x.shape) \
        == "jacobi"
    with pytest.raises(ValueError):
        tl.InvFlow(4, (3, 3), solver="no_such_solver")
