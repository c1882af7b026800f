"""ConvExp and ``exponential_cnn_mnist`` against the JAX package: the
spectral normalization, the series forward (6 terms), the exact forward
and the inverse (13), ldj and gradients; the carried power-iteration
vector ``u`` (data init, ``update_carry``, stacked in a RepeatedBlock, out
of the optimizer and the clamp, through the bridge and the checkpoint);
the series tail that the cheap eval leaves; and train steps of a reduced
``exponential_cnn_mnist`` against JAX's ``Experiment._train_step``.

Tolerances: values rtol 1e-5 (atol 1e-5), ldj atol 1e-4, gradients 1e-4
by norm, u and sigma 1e-5; the train steps as ``test_torch_train.py``
holds its trajectory (losses rtol 1e-5 at the first step, 2e-3 after).
"""

import copy
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_flow_tpu import layers as jl
from inverse_flow_tpu.data.loader import ArrayLoader as JaxLoader
from inverse_flow_tpu.layers import Flow as JaxFlow
from inverse_flow_tpu.layers import convexp as jce
from inverse_flow_tpu.models.glow import build_cnn_flow as jax_build_cnn
from inverse_flow_tpu.train.config import ExperimentConfig as JaxConfig
from inverse_flow_tpu.train.experiment import Experiment as JaxExperiment
from inverse_flow_tpu_torch import layers as tl
from inverse_flow_tpu_torch.bridge import params_from_jax, params_to_jax
from inverse_flow_tpu_torch.data.loader import ArrayLoader
from inverse_flow_tpu_torch.experiments import registry as tregistry
from inverse_flow_tpu_torch.layers import convexp as tce
from inverse_flow_tpu_torch.layers.sequential import Flow
from inverse_flow_tpu_torch.models.glow import build_cnn_flow
from inverse_flow_tpu_torch.ops.toeplitz import dense_conv_operator
from inverse_flow_tpu_torch.train.config import ExperimentConfig
from inverse_flow_tpu_torch.train.experiment import Experiment

B = 4
SHAPES = [(4, 6, 6), (68, 2, 2)]          # Conv1x1; Householder (C > 64)
SHAPE_IDS = ["c4", "c68-householder"]


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _nudged(params, seed, scale=0.05):
    """Every leaf but u moved off its init (zero biases would hide
    themselves)."""
    rs = np.random.RandomState(seed)
    out = jax.tree_util.tree_map(
        lambda l: np.asarray(l) + scale * rs.randn(*np.shape(l)).astype(
            np.float32), params)
    out["u"] = np.asarray(params["u"])
    return out


def _pair(shape, seed=0):
    jlayer = jl.ConvExp(shape)
    jparams = _nudged(jlayer.init(jax.random.PRNGKey(seed), shape)[0], 1)
    tlayer = tl.ConvExp(shape)
    params_from_jax(Flow(None, [tlayer]), [jparams])
    return jlayer, tlayer, jparams


def _input(shape, seed=0):
    return np.random.RandomState(seed).randn(B, *shape).astype(np.float32)


@pytest.mark.parametrize("n_iter", [1, 10])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_spectral_normalize_matches_jax(shape, n_iter):
    """The normalized kernel, u and sigma after ``n_iter`` power
    iterations from the same u; the kernel's gradient through sigma."""
    rs = np.random.RandomState(2)
    c = shape[0]
    k = (0.3 * rs.randn(c, c, 3, 3)).astype(np.float32)
    u = rs.randn(int(np.prod(shape))).astype(np.float32)
    u /= np.linalg.norm(u)
    kj, uj, sj = jce.spectral_normalize(jnp.asarray(k), jnp.asarray(u), shape,
                                        0.9, n_iter=n_iter)
    kt = torch.from_numpy(k).requires_grad_()
    kn, ut, st = tce.spectral_normalize(kt, torch.from_numpy(u), shape, 0.9,
                                        n_iter=n_iter)
    _close(kn.detach().numpy(), kj)
    _close(ut.numpy(), uj)
    _close(st.item(), sj)
    assert float(sj) > 0.9                    # the rescale acts
    gj = jax.grad(lambda k: jnp.sum(jce.spectral_normalize(
        k, jnp.asarray(u), shape, 0.9, n_iter=n_iter)[0] ** 2))(
            jnp.asarray(k))
    (kn ** 2).sum().backward()
    gj = np.asarray(gj)
    assert np.linalg.norm(kt.grad.numpy() - gj) <= 1e-4 * np.linalg.norm(gj)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_convexp_matches_jax(shape):
    """Forward (6 terms) and exact forward (13) values and ldj, the
    inverse of the exact forward's output, and the forward's gradients in
    x and every learnable parameter (u has none)."""
    jlayer, tlayer, jparams = _pair(shape)
    x = _input(shape)
    zj, lj = jlayer.forward(jparams, jnp.asarray(x))
    ezj, elj = jlayer.exact_forward(jparams, jnp.asarray(x))
    with torch.no_grad():
        zt, lt = tlayer(torch.from_numpy(x))
        ezt, elt = tlayer.exact_forward(torch.from_numpy(x))
        xt = tlayer.inverse(torch.from_numpy(np.asarray(ezj)))
    _close(zt.numpy(), zj)
    _close(lt.numpy(), lj, atol=1e-4)
    _close(ezt.numpy(), ezj)
    _close(elt.numpy(), elj, atol=1e-4)
    _close(xt.numpy(), jlayer.inverse(jparams, ezj), atol=2e-5)
    _close(xt.numpy(), x, atol=1e-4)
    assert tlayer.has_exact_path and tlayer.has_carry

    g = np.random.RandomState(3).randn(*zt.shape).astype(np.float32)

    def jloss(p, x):
        z, ldj = jlayer.forward(p, x)
        return jnp.sum(z * g) + jnp.sum(ldj)

    gp, gx = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(x))
    xg = torch.from_numpy(x).requires_grad_()
    z, ldj = tlayer(xg)
    (torch.sum(z * torch.from_numpy(g)) + ldj.sum()).backward()
    assert tlayer.u.grad is None and not tlayer.u.requires_grad
    theirs = {".".join(str(k.key) for k in path): v for path, v in
              jax.tree_util.tree_flatten_with_path(gp)[0]}
    pairs = [(xg.grad, gx)] + [(p.grad, theirs[n]) for n, p in
                               tlayer.named_parameters() if p.requires_grad]
    for ours, ref in pairs:
        ref = np.asarray(ref)
        assert np.linalg.norm(ours.numpy() - ref) <= 1e-4 * max(
            np.linalg.norm(ref), 1e-6)


def test_convexp_carry_matches_jax():
    """Data init's 10 power iterations and one ``update_carry`` write u
    as JAX's do; a RepeatedBlock of ConvExp steps keeps its stacked u out
    of the gradient and refreshes each step's slice as JAX's ``vmap``."""
    shape = (4, 6, 6)
    jlayer, tlayer, jparams = _pair(shape)
    x = _input(shape)
    jparams = jlayer.data_init(jparams, jnp.asarray(x))
    tlayer.data_init(torch.from_numpy(x))
    _close(tlayer.u.detach().numpy(), jparams["u"])
    jparams = jlayer.update_carry(jparams)
    tlayer.update_carry()
    _close(tlayer.u.detach().numpy(), jparams["u"])
    mask = jlayer.carry_mask(jparams)
    assert {n for n, p in tlayer.named_parameters()
            if not p.requires_grad} == {k for k, v in mask.items()
                                        if v is True}

    jblock = jl.RepeatedBlock((jl.ConvExp(shape),), 3)
    jbp = jblock.init(jax.random.PRNGKey(5), shape)[0]
    tblock = tl.RepeatedBlock(lambda: [tl.ConvExp(shape)], 3)
    params_from_jax(Flow(None, [tblock]), [jbp])
    u = tblock.get_parameter("steps.0.u")
    assert u.shape == (3, 144) and not u.requires_grad
    flow = Flow(None, [tblock])
    assert flow.has_carry
    flow.update_carry()
    _close(u.detach().numpy(), jblock.update_carry(jbp)["steps"][0]["u"])
    back = params_to_jax(flow)[0]
    _close(back["steps"][0]["u"], u.detach().numpy(), rtol=0, atol=0)


def test_convexp_series_tail_bounds_the_cheap_eval():
    """The 6-term value against the 13-term one: per example, the
    difference is at most sum_{k=7}^{13} s^k/k! times the series input's
    norm, s the normalized conv's spectral norm from its dense operator.
    The power iterations estimate sigma from below, so s lies a little
    above coeff (within 2% after data init's 10) and that tail within 1.3
    x coeff^7/7! (about 1e-4 at coeff 0.9). ConvExp adds no exact-ldj
    correction, so on a reduced ``exponential_cnn_mnist`` (4 ConvExp
    layers) the exact log p(x) stays within 4 x 1.3 x coeff^7/7! of the
    cheap one, relatively, in both packages alike."""
    shape = (4, 6, 6)
    jlayer, tlayer, jparams = _pair(shape)
    # a kernel whose norm is above the coefficient, so the rescale binds
    with torch.no_grad():
        tlayer.kernel.mul_(8.0)
        tlayer.data_init(None)
        p = tlayer.own_params()
        kernel = tlayer._kernel(p)
        s = torch.linalg.matrix_norm(dense_conv_operator(
            kernel, shape, padding=1), ord=2).item()
        x = torch.from_numpy(_input(shape))
        xin, _ = tlayer.conv1x1.forward_with(
            {"W": p["conv1x1.W"]}, x + p["pre_bias"])
        cheap, _ = tlayer(x)
        exact, _ = tlayer.exact_forward(x)
    tail = sum(s ** k / math.factorial(k) for k in range(7, 14))
    c7 = 0.9 ** 7 / math.factorial(7)
    assert 0.9 <= s <= 1.02 * 0.9 and tail <= 1.3 * c7
    diff = (exact - cheap).reshape(B, -1).norm(dim=1)
    assert (diff <= tail * xin.reshape(B, -1).norm(dim=1) * (1 + 1e-3)
            + 1e-5).all()
    assert diff.max() > 0

    jflow, tflow, _ = _cnn_pair()
    data = _data(2)
    gap = {}
    with torch.no_grad():
        _, cheap = tflow(torch.from_numpy(data))
        _, exact = tflow(torch.from_numpy(data), exact=True)
        corr = tflow.exact_ldj_correction((1, 8, 8))
    assert corr.item() == 0.0
    gap["torch"] = ((exact - cheap).abs() / cheap.abs()).numpy()
    jforward = jax.jit(jflow[0].forward, static_argnames="exact")
    jc = jforward(jflow[1], jnp.asarray(data))[1]
    je = jforward(jflow[1], jnp.asarray(data), exact=True)[1]
    gap["jax"] = np.abs(np.asarray(je - jc)) / np.abs(np.asarray(jc))
    for g in gap.values():
        assert (g <= 4 * 1.3 * c7).all()
    _close(exact.numpy(), je, rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# A reduced exponential_cnn_mnist: 2 blocks x 2 ConvExp layers on (1, 8, 8)
# ---------------------------------------------------------------------------

CNN_KW = dict(step_kind="convexp", num_blocks=2, block_size=2,
              activation="Spline", tail_bound=10.0)


def _data(n, seed=11):
    """Dequantized 8x8 images: the flows below start after
    Dequantization."""
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, (n, 1, 8, 8))
            + rs.uniform(0.0, 1.0, (n, 1, 8, 8))).astype(np.float32)


@functools.cache
def _jax_cnn():
    """The JAX flow after dequantization and its data-initialised params
    (built once: JAX's eager init takes seconds)."""
    jfull = jax_build_cnn((1, 8, 8), **CNN_KW)
    jflow = JaxFlow(jfull.base_distribution, jfull.layers[1:])
    jparams = jax.device_get(jflow.init(jax.random.PRNGKey(0), (1, 8, 8))[0])
    return jflow, jparams, jax.device_get(jax.jit(jflow.data_init)(
        jparams, jnp.asarray(_data(B))))


def _cnn_pair():
    """(the JAX flow and data-initialised params of :func:`_jax_cnn`, the
    port's flow after dequantization with them, the port's full flow)."""
    jflow, _, jparams = _jax_cnn()
    tfull = build_cnn_flow((1, 8, 8), **CNN_KW, device="cpu")
    tflow = Flow(tfull.base_distribution, tfull.layers[1:])
    params_from_jax(tflow, jax.device_get(jparams))
    return (jflow, jparams), tflow, tfull


def _config(tmp_path, cls, **kw):
    """``exponential_cnn_mnist``'s registry config at batch 4."""
    return cls(name="9L Conv Exponential Spline MNIST", lr=1e-3,
               batch_size=B, modified_grad=False, add_recon_grad=False,
               scheduler_name="None", log_timing=False, save_images=False,
               plot_recon=False, metrics_path=str(tmp_path / "m.jsonl"),
               checkpoint_path=str(tmp_path / "c.pt"), **kw)


def test_convexp_data_init_matches_jax():
    """The reduced model's data init (u by 10 power iterations per
    ConvExp, the rest untouched) from the same init, and its exact log
    p(x) afterwards (13-term series: the training path of a config
    without the modified gradient)."""
    jflow, jparams, _ = _jax_cnn()
    tfull = build_cnn_flow((1, 8, 8), **CNN_KW, device="cpu")
    tflow = Flow(tfull.base_distribution, tfull.layers[1:])
    params_from_jax(tflow, jax.device_get(jparams))
    x = _data(B)
    jparams = jax.jit(jflow.data_init)(jparams, jnp.asarray(x))
    tflow.data_init(torch.from_numpy(x))
    for a, b in zip(jax.tree_util.tree_leaves(params_to_jax(tflow)),
                    jax.tree_util.tree_leaves(jax.device_get(jparams))):
        _close(a, b)
    kinds = [type(l).__name__ for l in tfull.layers]
    assert kinds.count("ConvExp") == 4 and kinds.count("Squeeze") == 1
    _, lj = jax.jit(jflow.forward, static_argnames="exact")(
        jparams, jnp.asarray(x), exact=True)
    with torch.no_grad():
        _, lt = tflow(torch.from_numpy(x), exact=True)
    _close(lt.numpy(), lj, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("clamp", [None, 0.05], ids=["registry", "clamp"])
def test_exponential_train_steps_match_jax(tmp_path, clamp):
    """3 steps of JAX's ``Experiment._train_step`` and the port's
    ``train_step`` from the same weights: losses, and every parameter
    after each step, u included (u: one power iteration against the new
    kernel after the step, untouched by Adam and, with a weight clamp,
    by the clamp, which here binds on the other weights)."""
    (jflow, jparams), tflow, _ = _cnn_pair()
    data = _data(3 * B, seed=12)
    jexp = JaxExperiment(jflow, *(JaxLoader(data, B, native_prefetch=False)
                                  for _ in range(3)),
                         _config(tmp_path, JaxConfig, weight_clamp=clamp))
    jexp.state = jexp.state._replace(params=jparams,
                                     opt_state=jexp.tx.init(jparams))
    jexp._data_initialized = True
    texp = Experiment(tflow, *(ArrayLoader(data, B) for _ in range(3)),
                      _config(tmp_path, ExperimentConfig,
                              weight_clamp=clamp), device="cpu")
    texp._data_initialized = True
    us = [p for p in tflow.parameters() if not p.requires_grad]
    assert len(us) == 4
    in_opt = {id(p) for g in texp.optimizer.param_groups
              for p in g["params"]}
    assert not in_opt & {id(u) for u in us}

    for step in range(3):
        x = data[step * B:(step + 1) * B]
        before = [copy.deepcopy(l.own_params()) for l in tflow.layers
                  if isinstance(l, tl.ConvExp)]
        jexp.state, jloss, _ = jexp._train_step(jexp.state, jnp.asarray(x),
                                                jexp._next_rng())
        loss = float(texp.train_step(torch.from_numpy(x)))
        _close(loss, float(jloss), rtol=1e-5 if step == 0 else 2e-3)
        ours = params_to_jax(tflow)
        ref = jax.device_get(jexp.state.params)
        diffs = np.concatenate([np.abs(a - np.asarray(b)).ravel() for a, b in
                                zip(jax.tree_util.tree_leaves(ours),
                                    jax.tree_util.tree_leaves(ref))])
        assert (diffs > 1e-4).mean() <= 1e-3
        convexps = [l for l in tflow.layers if isinstance(l, tl.ConvExp)]
        for layer, prev in zip(convexps, before):
            with torch.no_grad():
                want = tce.spectral_normalize(
                    layer.kernel, prev["u"], layer.input_size, 0.9)[1]
            _close(layer.u.numpy(), want, rtol=0, atol=1e-6)
        for i, layer in enumerate(tflow.layers):
            if isinstance(layer, tl.ConvExp):
                _close(ours[i]["u"], ref[i]["u"], atol=1e-5)
    if clamp:
        assert max(p.abs().max().item()
                   for p in texp.params) <= clamp * (1 + 1e-6)
        assert max(u.abs().max().item() for u in us) > clamp


def test_checkpoint_and_registry_carry_u(tmp_path):
    """``exponential_cnn_mnist`` is registered with the JAX config and its
    model builds 9 ConvExp layers; a checkpoint keeps every u, and the
    resumed run's next step equals the original's."""
    spec = tregistry.get_experiment("exponential_cnn_mnist")
    assert "exponential_cnn_mnist" not in tregistry.NOT_PORTED
    full = spec.build_model(device="cpu",
                            generator=torch.Generator().manual_seed(0))
    assert sum(isinstance(l, tl.ConvExp) for l in full.layers) == 9
    assert [l.input_size for l in full.layers if isinstance(
        l, tl.ConvExp)][::3] == [(1, 28, 28), (4, 14, 14), (16, 7, 7)]

    _, tflow0, _ = _cnn_pair()
    data = _data(2 * B, seed=13)

    def experiment():
        return Experiment(copy.deepcopy(tflow0),
                          *(ArrayLoader(data, B) for _ in range(3)),
                          _config(tmp_path, ExperimentConfig), device="cpu")

    exp = experiment()
    exp._data_initialized = True
    exp.train_step(torch.from_numpy(data[:B]))
    exp.save()
    resumed = experiment()
    resumed.load()
    for a, b in zip(exp.flow.parameters(), resumed.flow.parameters()):
        assert torch.equal(a, b) and a.requires_grad == b.requires_grad
    x = torch.from_numpy(data[B:])
    assert torch.equal(exp.train_step(x), resumed.train_step(x))
    for a, b in zip(exp.flow.parameters(), resumed.flow.parameters()):
        assert torch.equal(a, b)
