"""SelfNorm and its machinery against the JAX package, on the CPU: the
conv primitives and the dense operators, the self-normalizing gradient,
``SelfNormConv``/``SelfNormFC`` on every path, the reduced
``selfnorm_glow_mnist`` (exact log p, the exact-correction identity, the
recon loss, the modified gradients), a GECO trajectory, the checkpoint's
GECO state and the per-layer recon detach inside a ``RepeatedBlock``.

Inputs come from numpy with a seed; weights cross with ``params_from_jax``.

Tolerances:
  * the conv and its gradients: rtol 1e-5 (atol 1e-5 for sums of a few
    hundred float32 products near 0);
  * dense operators: exact entries (a conv of a basis); slogdet rel 1e-5;
    the dense inverse rel 1e-4 by norm (a solve of a 784-dim operator);
  * the self-normalizing gradient: rel 1e-5 by norm, each of the four;
  * layer values rtol 1e-5 / atol 1e-5, exact inverses rel 1e-4 by norm,
    recon-loss gradients rel 1e-5 by norm;
  * the reduced model: log p rtol 1e-5, exact = cheap + correction rel
    1e-5 per sample, gradients rel 1e-4 by norm (float32 through 10
    layers and a backward);
  * GECO: losses rel 2e-3 over 10 Adam steps (as
    ``test_torch_train.py::test_trajectory_matches_jax``), the first loss
    rel 1e-5, ``recon_weight`` rel 1e-4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_flow_tpu.data.loader import ArrayLoader as JaxLoader
from inverse_flow_tpu.layers import Flow as JaxFlow
from inverse_flow_tpu.layers import selfnorm as jsn
from inverse_flow_tpu.models.glow import build_glow as jax_build_glow
from inverse_flow_tpu.ops import convs as jconvs
from inverse_flow_tpu.ops import toeplitz as jtoep
from inverse_flow_tpu.train.config import ExperimentConfig as JaxConfig
from inverse_flow_tpu.train.experiment import Experiment as JaxExperiment
from inverse_flow_tpu_torch import layers as tl
from inverse_flow_tpu_torch.bridge import params_from_jax, params_to_jax
from inverse_flow_tpu_torch.data.loader import ArrayLoader
from inverse_flow_tpu_torch.layers import Flow
from inverse_flow_tpu_torch.layers import selfnorm as tsn
from inverse_flow_tpu_torch.models.glow import build_glow
from inverse_flow_tpu_torch.ops import convs as tconvs
from inverse_flow_tpu_torch.ops import toeplitz as ttoep
from inverse_flow_tpu_torch.train.config import ExperimentConfig
from inverse_flow_tpu_torch.train.experiment import Experiment

from test_torch_sample import _jax_draws


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _load(tlayer, jparams):
    params_from_jax(Flow(None, [tlayer]), [jparams])


# ---------------------------------------------------------------------------
# ops/convs.py and ops/toeplitz.py
# ---------------------------------------------------------------------------

CONV_CASES = [(s, p, g) for s in (1, 2) for p in (0, 1) for g in (1, 2)]


@pytest.mark.parametrize("stride,padding,groups", CONV_CASES,
                         ids=[f"s{s}p{p}g{g}" for s, p, g in CONV_CASES])
def test_conv_and_its_gradients_match_jax(stride, padding, groups):
    """An odd input (9x7) under stride 2 leaves a remainder: the input
    gradient still takes the input's shape, as JAX's remainder padding
    gives it."""
    rs = np.random.RandomState(stride * 10 + padding * 2 + groups)
    x = rs.randn(3, 4, 9, 7).astype(np.float32)
    w = rs.randn(6, 4 // groups, 3, 3).astype(np.float32)
    conv = dict(stride=stride, padding=padding, groups=groups)
    z = tconvs.conv2d(_t(x), _t(w), **conv)
    z_ref = jconvs.conv2d(x, w, **conv)
    np.testing.assert_allclose(z.numpy(), z_ref, rtol=1e-5, atol=1e-5)
    g = rs.randn(*z.shape).astype(np.float32)
    dx = tconvs.conv2d_input_grad(_t(g), _t(w), x.shape, **conv)
    dx_ref = jconvs.conv2d_input_grad(g, w, x.shape, **conv)
    assert dx.shape == x.shape
    np.testing.assert_allclose(dx.numpy(), dx_ref, rtol=1e-5, atol=1e-5)
    dw = tconvs.conv2d_weight_grad(_t(g), _t(x), w.shape, **conv)
    dw_ref = jconvs.conv2d_weight_grad(g, x, w.shape, **conv)
    np.testing.assert_allclose(dw.numpy(), dw_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel,padding", [((1, 1), 0), ((3, 3), 1)],
                         ids=["1x1", "3x3p1"])
def test_dense_operators_match_jax(kernel, padding):
    rs = np.random.RandomState(3)
    shape = (4, 14, 14)
    w = (rs.randn(4, 4, *kernel) * 0.1).astype(np.float32)
    w[:, :, kernel[0] // 2, kernel[1] // 2] += np.eye(4, dtype=np.float32)
    t = ttoep.dense_conv_operator(_t(w), shape, padding=padding)
    t_ref = jtoep.dense_conv_operator(w, shape, padding=padding)
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_ref))
    ld = ttoep.conv_logdet(_t(w), shape, padding=padding)
    ld_ref = jtoep.conv_logdet(w, shape, padding=padding)
    assert abs(float(ld) - float(ld_ref)) <= 1e-5 * abs(float(ld_ref))
    z = rs.randn(3, *shape).astype(np.float32)
    x = ttoep.conv_exact_inverse(_t(z), _t(w), shape, padding=padding)
    x_ref = jtoep.conv_exact_inverse(z, w, shape, padding=padding)
    assert _rel(x.numpy(), x_ref) <= 1e-4


# ---------------------------------------------------------------------------
# The self-normalizing gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,padding", [((1, 1), 0), ((3, 3), 1)],
                         ids=["1x1", "3x3p1"])
def test_selfnorm_conv2d_gradients_match_jax_custom_vjp(kernel, padding):
    rs = np.random.RandomState(4)
    x = rs.randn(5, 4, 6, 6).astype(np.float32)
    w = rs.randn(4, 4, *kernel).astype(np.float32)
    r = rs.randn(4, 4, *kernel).astype(np.float32)
    b = rs.randn(4).astype(np.float32)
    g = rs.randn(5, 4, 6, 6).astype(np.float32)

    def jloss(x, w, b, r):
        return jnp.sum(jsn.selfnorm_conv2d(x, w, b, r, 1, padding) * g)

    refs = jax.grad(jloss, argnums=(0, 1, 2, 3))(x, w, b, r)
    leaves = [_t(a).requires_grad_() for a in (x, w, b, r)]
    z = tsn.selfnorm_conv2d(*leaves, 1, padding)
    np.testing.assert_allclose(
        z.detach().numpy(), jsn.selfnorm_conv2d(x, w, b, r, 1, padding),
        rtol=1e-5, atol=1e-5)
    ours = torch.autograd.grad(z, leaves, _t(g))
    for name, a, ref in zip("xwbr", ours, refs):
        assert _rel(a.numpy(), ref) <= 1e-5, name


# ---------------------------------------------------------------------------
# SelfNormConv and SelfNormFC
# ---------------------------------------------------------------------------

LAYER_CASES = {
    "conv1x1": lambda: (jsn.SelfNormConv(4, 4, (1, 1)),
                        tsn.SelfNormConv(4, 4, (1, 1)), (4, 6, 6)),
    "conv3x3p1": lambda: (jsn.SelfNormConv(4, 4, (3, 3), padding=1),
                          tsn.SelfNormConv(4, 4, (3, 3), padding=1),
                          (4, 6, 6)),
    "fc": lambda: (jsn.SelfNormFC(12, 12), tsn.SelfNormFC(12, 12), (12,)),
}


def _layer_pair(name, seed=5):
    """The JAX layer, its params off the identity (init + 0.1 noise, r
    independent of w), and the port's layer with them."""
    jlayer, tlayer, shape = LAYER_CASES[name]()
    jparams, _ = jlayer.init(jax.random.PRNGKey(seed), shape)
    rs = np.random.RandomState(seed)
    jparams = {k: np.asarray(v) + 0.1 * rs.randn(*v.shape).astype(
        np.float32) for k, v in jparams.items()}
    _load(tlayer, jparams)
    x = rs.randn(3, *shape).astype(np.float32)
    return jlayer, jparams, tlayer, x


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_selfnorm_layer_paths_match_jax(name):
    """Cheap forward and inverse, exact forward (values and dense ldj),
    exact inverse, and the exact-ldj correction."""
    jlayer, jparams, tlayer, x = _layer_pair(name)
    shape = x.shape[1:]
    z, ldj = tlayer(_t(x))
    z_ref, ldj_ref = jlayer.forward(jparams, x)
    np.testing.assert_allclose(z.detach().numpy(), z_ref, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ldj.detach().numpy(), ldj_ref)
    np.testing.assert_allclose(
        tlayer.inverse(z.detach()).detach().numpy(),
        jlayer.inverse(jparams, z_ref), rtol=1e-5, atol=1e-5)
    ze, lde = tlayer.exact_forward(_t(x))
    ze_ref, lde_ref = jlayer.exact_forward(jparams, x)
    np.testing.assert_allclose(ze.detach().numpy(), ze_ref, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lde.detach().numpy(), lde_ref, rtol=1e-5)
    assert tlayer.has_exact_path and lde.shape == (3,)
    xe = tlayer.exact_inverse(ze.detach()).detach().numpy()
    assert _rel(xe, jlayer.exact_inverse(jparams, ze_ref)) <= 1e-4
    assert _rel(xe, x) <= 1e-4
    corr = tlayer.exact_ldj_correction_with(tlayer.own_params(), shape)
    corr_ref = jlayer.exact_ldj_correction(jparams, shape)
    assert corr.shape == ()
    np.testing.assert_allclose(float(corr.detach()), float(corr_ref),
                               rtol=1e-5)


RECON_MODES = [dict(), dict(sym=True), dict(only_R=True),
               dict(sym=True, only_R=True)]


@pytest.mark.parametrize("name", list(LAYER_CASES))
@pytest.mark.parametrize("mode", RECON_MODES,
                         ids=["plain", "sym", "only_R", "sym_only_R"])
def test_selfnorm_recon_loss_and_its_gradients_match_jax(name, mode):
    jlayer, jparams, tlayer, x = _layer_pair(name)
    loss = tlayer.recon_loss_with(tlayer.own_params(), _t(x), **mode)
    loss_ref = jlayer.recon_loss(jparams, x, **mode)
    np.testing.assert_allclose(loss.detach().numpy(), loss_ref, rtol=1e-5)
    refs = jax.grad(lambda p: jnp.mean(jlayer.recon_loss(p, x, **mode)))(
        jparams)
    params = tlayer.own_params()
    ours = dict(zip(params, torch.autograd.grad(
        loss.mean(), list(params.values()), allow_unused=True)))
    for k, ref in refs.items():
        if not np.any(np.asarray(ref)):
            assert ours[k] is None or not ours[k].any(), k
            continue
        assert _rel(ours[k].numpy(), ref) <= 1e-5, k


def test_selfnorm_inits():
    """The 1x1 conv starts orthogonal (QR; W^T W = I), a 3x3 as the
    identity at the centre tap in small noise, the FC with the identity
    set in noise; ``r`` is ``flip(w)`` in each; a strided exact inverse
    raises."""
    gen = torch.Generator().manual_seed(0)
    conv1 = tsn.SelfNormConv(8, 8, (1, 1), generator=gen, device="cpu")
    w = conv1.w.detach()[:, :, 0, 0]
    torch.testing.assert_close(w.T @ w, torch.eye(8), atol=1e-5, rtol=0)
    conv3 = tsn.SelfNormConv(8, 8, (3, 3), padding=1, generator=gen,
                             device="cpu")
    centre = conv3.w.detach()[:, :, 1, 1]
    off = conv3.w.detach().clone()
    off[:, :, 1, 1] -= torch.eye(8)
    assert off.abs().max() < 0.05
    assert (centre.diagonal() - 1).abs().max() < 0.05
    fc = tsn.SelfNormFC(8, 8, generator=gen, device="cpu")
    torch.testing.assert_close(fc.w.detach()[:, :, 0, 0], torch.eye(8),
                               rtol=0, atol=0)
    for layer in (conv1, conv3, fc):
        torch.testing.assert_close(layer.r.detach(),
                                   tsn.flip_kernel(layer.w.detach()),
                                   rtol=0, atol=0)
    strided = tsn.SelfNormConv(4, 4, (2, 2), stride=2, device="cpu")
    with pytest.raises(NotImplementedError):
        strided.exact_inverse(torch.zeros(1, 4, 3, 3))


# ---------------------------------------------------------------------------
# The reduced selfnorm_glow_mnist
# ---------------------------------------------------------------------------

SIZE = (1, 28, 28)
MODEL_KW = dict(step_kind="snf", num_blocks=2, block_size=2,
                coupling_width=16, activation="None")
B = 8


@pytest.fixture(scope="module")
def snf_init():
    """The model after dequantization in JAX, its params from seed 0
    (under jit), and pre-dequantized data."""
    jfull = jax_build_glow(SIZE, **MODEL_KW)
    jflow = JaxFlow(jfull.base_distribution, jfull.layers[1:])
    jparams = jax.device_get(jax.jit(
        lambda key: jfull.init(key, SIZE)[0])(jax.random.PRNGKey(0)))[1:]
    rs = np.random.RandomState(6)
    data = (rs.randint(0, 256, (3 * B,) + SIZE)
            + rs.uniform(0.0, 1.0, (3 * B,) + SIZE)).astype(np.float32)
    return jflow, jparams, data


def _snf_pair(snf_init, w_noise, r_noise):
    """(JAX flow, its params with the SelfNorm kernels moved off their
    init by Gaussian noise of these scales, the port's flow with them,
    data)."""
    jflow, jparams, data = snf_init
    jparams = copy.deepcopy(jparams)
    rs = np.random.RandomState(7)
    for p in jparams:
        for step in p.get("steps", []):
            for k, scale in (("w", w_noise), ("r", r_noise)) \
                    if "r" in step else ():
                step[k] = step[k] + scale * rs.randn(
                    *step[k].shape).astype(np.float32)
    tfull = build_glow(SIZE, **MODEL_KW, device="cpu")
    tflow = Flow(tfull.base_distribution, tfull.layers[1:])
    params_from_jax(tflow, jparams)
    return jflow, jparams, tflow, data


@pytest.fixture(scope="module")
def snf_glow(snf_init):
    """w off orthogonal (so that the exact correction is far from 0) and
    r off ``flip(w)``."""
    return _snf_pair(snf_init, 0.2, 0.2)


def test_snf_glow_exact_logp_and_correction_match_jax(snf_glow):
    jflow, jparams, tflow, data = snf_glow
    x = data[:B]
    with torch.no_grad():
        cheap = tflow(_t(x))[1].numpy()
        exact = tflow(_t(x), exact=True)[1].numpy()
        corr = float(tflow.exact_ldj_correction(SIZE))
    ref_cheap = jax.jit(lambda p, x: jflow.forward(p, x)[1])(jparams, x)
    ref_exact = jax.jit(lambda p, x: jflow.forward(p, x, exact=True)[1])(
        jparams, x)
    ref_corr = jax.jit(lambda p: jflow.exact_ldj_correction(p, SIZE))(
        jparams)
    np.testing.assert_allclose(cheap, ref_cheap, rtol=1e-5)
    np.testing.assert_allclose(exact, ref_exact, rtol=1e-5)
    np.testing.assert_allclose(corr, float(ref_corr), rtol=1e-5)
    assert corr != 0.0
    np.testing.assert_allclose(exact, cheap + corr, rtol=1e-5)


def test_snf_glow_recon_loss_matches_jax(snf_glow):
    jflow, jparams, tflow, data = snf_glow
    x = data[:B]
    for mode in RECON_MODES[:2]:
        with torch.no_grad():
            ours = tflow.recon_loss(_t(x), **mode).numpy()
        ref = jax.jit(lambda p, x: jflow.recon_loss(p, x, **mode))(
            jparams, x)
        np.testing.assert_allclose(ours, ref, rtol=1e-5)


@pytest.mark.parametrize("exact", [False, True], ids=["cheap", "exact"])
def test_snf_glow_sample_matches_jax(snf_glow, exact):
    """``Flow.sample`` on JAX's draws, through the cheap inverses (the
    convs with ``r``) or the exact ones (dense solves); the exact round
    trip ``reconstruct(exact=True)`` on the flow without a SplitPrior
    draw gives the input back."""
    jflow, jparams, tflow, data = snf_glow
    rng = jax.random.PRNGKey(4)
    ref = np.asarray(jax.jit(lambda p, r: jflow.sample(
        p, r, B, exact=exact))(jparams, rng))
    ours = tflow.sample(B, noise=_jax_draws(jflow, rng, B),
                        exact=exact).numpy()
    assert np.isfinite(ours).all()
    assert _rel(ours, ref) <= 1e-4
    if exact:
        x = _t(data[:B])
        with torch.no_grad():
            z = tflow(x, exact=True)[0]
            split = [i for i, l in enumerate(tflow.layers)
                     if isinstance(l, tl.SplitPrior)][0]
            h = x
            for layer in tflow.layers[:split]:
                h = layer.exact_forward(h)[0] if layer.has_exact_path \
                    else layer(h)[0]
            half = tl.Coupling.forward_with(
                tflow.layers[split], tflow.layers[split].own_params(),
                h)[0][:, h.shape[1] // 2:]
        back = tflow.sample(B, noise={"base": z, split: half}, exact=True)
        assert _rel(back.numpy(), data[:B]) <= 1e-4


def _grad_tree(flow):
    """The flow's gradients as a JAX params tree."""
    g = copy.deepcopy(flow)
    for p, q in zip(g.parameters(), flow.parameters()):
        p.data = q.grad.clone()
    return params_to_jax(g)


def test_snf_glow_modified_gradients_match_jax(snf_glow):
    """-log p(x) on the cheap path plus 100 x the symmetric recon loss:
    the gradients of every leaf against ``jax.grad`` of the same loss
    (the JAX ``loss_fn``'s terms)."""
    jflow, jparams, tflow, data = snf_glow
    x = data[:B]
    weight = 100.0

    def jloss(p):
        nll = -jflow.forward(p, x)[1]
        recon = jnp.mean(jflow.recon_loss(p, x, sym=True))
        return jnp.sum(nll) / B + weight * recon

    refs = jax.jit(jax.grad(jloss))(jparams)
    tflow.zero_grad()
    loss = (-tflow(_t(x))[1]).sum() / B + weight * tflow.recon_loss(
        _t(x), sym=True).mean()
    loss.backward()
    ours = _grad_tree(tflow)
    tflow.zero_grad()
    for (path, ref), a in zip(jax.tree_util.tree_leaves_with_path(refs),
                              jax.tree_util.tree_leaves(ours)):
        if not np.any(np.asarray(ref)):
            assert not np.any(a), path
            continue
        assert _rel(a, ref) <= 1e-4, path


# ---------------------------------------------------------------------------
# GECO and the checkpoint
# ---------------------------------------------------------------------------

def _geco_config(tmp_path, cls):
    """``geco_selfnorm_glow_mnist``'s config at batch 8."""
    return cls(name="geco", lr=1e-3, batch_size=B, modified_grad=True,
               add_recon_grad=True, recon_loss_weight=1.0,
               recon_loss_lr=1e-3, scheduler_name="None", log_timing=False,
               save_images=False, plot_recon=False,
               metrics_path=str(tmp_path / "m.jsonl"),
               checkpoint_path=str(tmp_path / "c.pkl"))


def test_geco_trajectory_matches_jax(tmp_path, snf_init):
    """10 Adam steps through JAX's ``Experiment._train_step`` and the
    port's ``train_step`` from the same weights (JAX's init, r off
    ``flip(w)`` by 0.01): losses and the GECO weight after every step."""
    jflow, jparams, tflow0, data = _snf_pair(snf_init, 0.0, 0.01)
    jexp = JaxExperiment(jflow, *(JaxLoader(data, B, native_prefetch=False)
                                  for _ in range(3)),
                         _geco_config(tmp_path, JaxConfig))
    jexp.state = jexp.state._replace(params=jparams,
                                     opt_state=jexp.tx.init(jparams))
    jexp._data_initialized = True
    tflow = copy.deepcopy(tflow0)
    texp = Experiment(tflow, *(ArrayLoader(data, B) for _ in range(3)),
                      _geco_config(tmp_path, ExperimentConfig),
                      device="cpu")
    texp._data_initialized = True

    ours, ref, w_ours, w_ref = [], [], [], []
    for step in range(10):
        x = data[(step % 3) * B:(step % 3 + 1) * B]
        jexp.state, loss, _ = jexp._train_step(jexp.state, jnp.asarray(x),
                                               jexp._next_rng())
        ref.append(float(loss))
        w_ref.append(float(jexp.state.recon_weight))
        ours.append(float(texp.train_step(torch.from_numpy(x))))
        w_ours.append(float(texp.recon_weight))
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(ours, ref, rtol=2e-3)
    np.testing.assert_allclose(w_ours, w_ref, rtol=1e-4)
    assert np.isfinite(w_ours).all() and w_ours[-1] > 2.0   # it moved
    np.testing.assert_allclose(float(texp.recon_ema),
                               float(jexp.state.recon_ema), rtol=1e-3)


def test_checkpoint_keeps_the_geco_state(tmp_path, snf_init):
    """A resumed GECO run continues its weight and average: two steps,
    save, a fresh Experiment loads, and its next step equals the
    original's."""
    _, _, tflow0, data = _snf_pair(snf_init, 0.0, 0.01)
    x = torch.from_numpy(data[:B])

    def experiment():
        return Experiment(copy.deepcopy(tflow0),
                          *(ArrayLoader(data, B) for _ in range(3)),
                          _geco_config(tmp_path, ExperimentConfig),
                          device="cpu")

    exp = experiment()
    exp._data_initialized = True
    for _ in range(2):
        exp.train_step(x)
    exp.save()
    resumed = experiment()
    resumed.load()
    assert float(resumed.recon_weight) == float(exp.recon_weight) != 1.0
    assert float(resumed.recon_ema) == float(exp.recon_ema)
    assert resumed.step == exp.step == 2
    exp.train_step(x)
    resumed.train_step(x)
    assert float(resumed.recon_weight) == float(exp.recon_weight)


# ---------------------------------------------------------------------------
# The recon detach inside a RepeatedBlock
# ---------------------------------------------------------------------------

def test_repeated_block_recon_detaches_before_every_layer():
    """Each SelfNorm layer's recon gradient reaches its own weights only:
    the ActNorm before it in the same step gets none (a detach at step
    boundaries only would leak one into it), and the block's loss equals
    the sum of each layer's loss on its own detached input."""
    gen = torch.Generator().manual_seed(1)
    block = tl.RepeatedBlock(lambda: [
        tl.ActNorm(4, generator=gen, device="cpu"),
        tsn.SelfNormConv(4, 4, (1, 1), generator=gen, device="cpu")], 3)
    with torch.no_grad():
        block.steps[0].log_scale.add_(0.3)
        block.steps[1].r.add_(0.1 * torch.randn(
            block.steps[1].r.shape, generator=gen))
    x = torch.randn((5, 4, 3, 3), generator=gen)
    loss = block.recon_loss_with(block.own_params(), x, sym=True)
    grads = dict(zip(dict(block.named_parameters()), torch.autograd.grad(
        loss.sum(), list(block.parameters()), allow_unused=True)))
    assert grads["steps.0.log_scale"] is None
    assert grads["steps.0.translation"] is None
    assert grads["steps.1.w"].abs().sum() > 0

    expected, h = torch.zeros(5), x
    for k in range(3):
        for layer, pk in zip(block.steps, block._step_params(k)):
            if layer.has_recon_loss:
                expected = expected + layer.recon_loss_with(pk, h, sym=True)
            h = layer.forward_with(pk, h)[0]
    torch.testing.assert_close(loss, expected, rtol=1e-6, atol=0)
