"""Gaussianize, GaussianizeSplit and the FastFlow ImageNet model against
the JAX package.

The layers on nudged JAX params (their convs start at zero, which would
hide them): values, ldj, inverses and gradients. ``build_fastflow`` at the
JAX test's own small shape ((3, 16, 16), 2 levels x 2 steps, coupling
width 16; ``tests/test_layers.py:318-319``), after dequantization: log
p(x) and its gradients, ``Flow.sample`` on JAX's own draws, the bridge
both ways. Tolerances: values rtol 1e-5 (atol 1e-5), ldj atol 1e-4, log
p(x) rtol 1e-5, gradients 1e-4 by norm.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_flow_tpu import layers as jl
from inverse_flow_tpu.experiments import registry as jregistry
from inverse_flow_tpu.layers import Flow as JaxFlow
from inverse_flow_tpu.models.fastflow import build_fastflow as jax_fastflow
from inverse_flow_tpu_torch import layers as tl
from inverse_flow_tpu_torch.bridge import params_from_jax, params_to_jax
from inverse_flow_tpu_torch.experiments import registry as tregistry
from inverse_flow_tpu_torch.layers.sequential import Flow
from inverse_flow_tpu_torch.models.fastflow import build_fastflow
from inverse_flow_tpu_torch.ops import fused_chain as tfc
from inverse_flow_tpu_torch.train.config import check_ported

B = 3


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _nudged(params, seed, scale=0.1):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda l: np.asarray(l) + scale * rs.randn(*np.shape(l)).astype(
            np.float32), params)


def _grads_close(ours, ref):
    ref = np.asarray(ref)
    assert np.linalg.norm(ours.numpy() - ref) <= 1e-4 * max(
        np.linalg.norm(ref), 1e-6)


LAYERS = {
    "gaussianize": lambda: (jl.Gaussianize(2), tl.Gaussianize(2)),
    "gaussianize_split": lambda: (jl.GaussianizeSplit((4, 6, 6)),
                                  tl.GaussianizeSplit((4, 6, 6))),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_gaussianize_matches_jax(name):
    """Forward values and ldj, the gradients in x and every parameter,
    and the inverse (GaussianizeSplit's on the factored-out half the
    forward gave, as ``noise``; without a generator or noise it raises);
    at the zero init the layer is the identity."""
    jlayer, tlayer = LAYERS[name]()
    shape = (4, 6, 6)
    zero, out_shape = jlayer.init(jax.random.PRNGKey(0), shape)
    assert tlayer.out_shape(shape) == out_shape
    jparams = _nudged(zero, 1)
    params_from_jax(Flow(None, [tlayer]), [jparams])
    x = np.random.RandomState(2).randn(B, *shape).astype(np.float32)
    zj, lj = jax.jit(jlayer.forward)(jparams, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    zt, lt = tlayer(xt)
    _close(zt.detach().numpy(), zj)
    _close(lt.detach().numpy(), lj, atol=1e-4)

    g = np.random.RandomState(3).randn(*zt.shape).astype(np.float32)
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(
        jlayer.forward(p, x)[0] * g) + jnp.sum(jlayer.forward(p, x)[1]),
        argnums=(0, 1)))(jparams, jnp.asarray(x))
    (torch.sum(zt * torch.from_numpy(g)) + lt.sum()).backward()
    _grads_close(xt.grad, gx)
    for n, p in tlayer.named_parameters():
        _grads_close(p.grad, gp[n])

    with torch.no_grad():
        if name == "gaussianize":
            back = tlayer.inverse(torch.from_numpy(np.asarray(zj)))
            _close(back.numpy(), jlayer.inverse(jparams, zj))
        else:
            z2 = jlayer.gaussianize.forward_split(
                jparams, jnp.asarray(x[:, :2]), jnp.asarray(x[:, 2:]))[0]
            back = tlayer.inverse(torch.from_numpy(np.asarray(zj)),
                                  noise=torch.from_numpy(np.asarray(z2)))
            with pytest.raises(ValueError):
                tlayer.inverse(torch.from_numpy(np.asarray(zj)))
            drawn = tlayer.inverse(torch.from_numpy(np.asarray(zj)),
                                   torch.Generator().manual_seed(0))
            assert drawn.shape == x.shape
        _close(back.numpy(), x, atol=2e-5)
        params_from_jax(Flow(None, [tlayer]), [zero])
        z0, l0 = tlayer(torch.from_numpy(x))
    if name == "gaussianize":
        _close(z0.numpy(), x, rtol=0, atol=0)
        assert not l0.any()
    else:
        _close(z0.numpy(), x[:, :2], rtol=0, atol=0)
        _close(l0.numpy(), -0.5 * (x[:, 2:] ** 2 + np.log(2 * np.pi)).reshape(
            B, -1).sum(-1), atol=1e-4)


# ---------------------------------------------------------------------------
# build_fastflow at the JAX test's small shape
# ---------------------------------------------------------------------------

SIZE = (3, 16, 16)
FF_KW = dict(n_blocks=2, block_size=2, coupling_width=16)


def _data(n, seed=21):
    """Dequantized images: the flows below start after Dequantization."""
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, (n,) + SIZE)
            + rs.uniform(0.0, 1.0, (n,) + SIZE)).astype(np.float32)


@functools.cache
def _jax_model(actnorm):
    """JAX's FastFlow without its Dequantization and its params: data
    init (ActNorm) on a batch, then every leaf nudged by 0.01 so that the
    zero-initialized convs and the Gaussianize heads are seen."""
    jfull = jax_fastflow(SIZE, actnorm=actnorm, **FF_KW)
    jflow = JaxFlow(jfull.base_distribution, jfull.layers[1:])
    params = jflow.init(jax.random.PRNGKey(0), SIZE)[0]    # numpy QR
    params = jax.jit(jflow.data_init)(params, jnp.asarray(_data(B)))
    return jflow, _nudged(jax.device_get(params), 5, 0.01)


def _pair(actnorm):
    jflow, jparams = _jax_model(actnorm)
    tfull = build_fastflow(SIZE, actnorm=actnorm, **FF_KW, device="cpu")
    tflow = Flow(tfull.base_distribution, tfull.layers[1:])
    params_from_jax(tflow, jparams)
    return jflow, jparams, tflow, tfull


@pytest.mark.parametrize("actnorm", [True, False], ids=["actnorm", "plain"])
def test_fastflow_log_prob_and_gradients_match_jax(actnorm):
    """log p(x) (rtol 1e-5) and the gradients of its mean in every
    parameter (1e-4 by norm); the layers in the JAX order, each level's
    steps one RepeatedBlock of InvFlow TL, {ActNorm}, Conv1x1, Coupling;
    no chain launch on the CPU."""
    jflow, jparams, tflow, tfull = _pair(actnorm)
    kinds = [type(l).__name__ for l in tfull.layers]
    assert kinds == ["Dequantization", "Normalization", "Normalization",
                     "LogitTransform", "Squeeze", "RepeatedBlock",
                     "GaussianizeSplit", "Squeeze", "RepeatedBlock"]
    steps = [type(l).__name__ for l in tfull.layers[5].steps]
    assert steps == ["InvFlow"] + ["ActNorm"] * actnorm + ["Conv1x1",
                                                           "Coupling"]
    assert tfull.layers[5].steps[0].order == "TL"
    x = _data(B, seed=22)
    lj, gj = jax.jit(jax.value_and_grad(lambda p, x: jnp.mean(
        jflow.forward(p, x)[1])))(jparams, jnp.asarray(x))
    before = tfc.chain_phases.launches
    z, lp = tflow(torch.from_numpy(x))
    assert tfc.chain_phases.launches == before
    assert z.shape == (B, 24, 4, 4)
    lp.mean().backward()
    _close(lp.mean().item(), lj, rtol=1e-5, atol=0)
    _, lpj = jax.jit(jflow.forward)(jparams, jnp.asarray(x))
    _close(lp.detach().numpy(), lpj, rtol=1e-5, atol=0)
    theirs = dict(_flat(gj))
    ours = dict(tflow.named_parameters())
    assert {n.partition(".")[2] for n in ours} == set(theirs)
    for n, p in ours.items():
        # the port's layers.i.rest is the JAX tree's i.rest
        _grads_close(p.grad, theirs[n.partition(".")[2]])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def test_fastflow_sample_and_bridge_match_jax():
    """``Flow.sample`` on JAX's own draws (the base's z and the
    GaussianizeSplit's half from its layer rng) gives JAX's samples; the
    bridge round trip gives the JAX params back."""
    jflow, jparams, tflow, _ = _pair(True)
    rng = jax.random.PRNGKey(7)
    ref = np.asarray(jax.jit(lambda p, r: jflow.sample(p, r, B))(jparams,
                                                                  rng))
    r, base_rng = jax.random.split(rng)
    noise = {"base": jflow.base_distribution.sample(base_rng, B)[0]}
    rngs = jflow._layer_rngs(r, salt=1)
    for i, layer in enumerate(jflow.layers):
        if isinstance(layer, jl.GaussianizeSplit):
            noise[i] = layer.base.sample(rngs[i], B)[0]
    out = tflow.sample(B, noise={k: torch.from_numpy(np.array(v))
                                 for k, v in noise.items()})
    assert out.shape == (B,) + SIZE
    _close(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    back = params_to_jax(tflow)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jparams))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_fastflow_registry_spec():
    """``if_imagenet_multi_gpu`` is registered (its spec is
    ``FASTFLOW_IMAGENET32``) with JAX's config field by field, data
    parallelism included, which the port takes; the spec builds the
    paper's model."""
    spec = tregistry.get_experiment("if_imagenet_multi_gpu")
    assert spec is tregistry.FASTFLOW_IMAGENET32
    ref = jregistry.get_experiment("if_imagenet_multi_gpu")
    for f in dataclasses.fields(ref.config):
        assert getattr(spec.config, f.name) == getattr(ref.config, f.name)
    assert spec.config.data_parallel
    check_ported(spec.config)
    flow = spec.build_model(device="meta")
    kinds = [type(l).__name__ for l in flow.layers]
    assert kinds.count("GaussianizeSplit") == 2
    assert [l.n_repeats for l in flow.layers
            if isinstance(l, tl.RepeatedBlock)] == [48, 48, 48]
    assert flow.layers[5].get_parameter("steps.2.w2").shape == (48, 12, 512,
                                                                1, 1)
