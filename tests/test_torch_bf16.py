"""The bf16 coupling nets and ``bench.py``'s configurations against the
JAX package, on the CPU.

``Coupling(compute_dtype="bfloat16")`` and ``SplitPrior`` against the JAX
layers in bf16, both held to the same float32 reference; the policy's
invariants (zero init gives the float32 result exactly, the round trip
undoes the forward, a small per-layer ldj delta at a realistic weight
scale); the float32 path is the parent's formula bit for bit; a reduced
imagenet32 model with bf16 couplings against JAX's and against float32,
and a few Adam steps of it; every ``bench_configs`` name against the JAX
builder's parameter shapes.

Inputs and weights come from numpy with a seed (the zero-initialized
``w3``, ``b3``, ``logs3`` moved off zero, or the comparison would be of
zeros). JAX's CPU conv may accumulate a bf16 conv in bf16
(``inverse_flow_tpu/layers/coupling.py:40-44``) and torch's CPU conv
rounds differently, so the two packages' bf16 results are held to each
other and to float32 within bf16 ulps of the largest magnitude:
``BF16_ULP`` = 2^-7, the spacing of bf16 numbers in [1, 2).

Tolerances: the net output within 8 ulps of max|h| of each other and 16
of float32 (three convs, each output and input rounded to bf16); the
layer's z and ldj of the two packages' bf16 runs rtol 1e-2 atol 1e-2 x
max; zero init and the float32 path exactly; the round trip 1e-6 x
max(1, |x|); the ldj delta under 2e-3 bpd (JAX
``tests/test_mixed_precision.py:56-67``); the reduced model's log p in
bf16 within 2e-3 bpd of float32 (that bound, for the whole model) and
1e-3 bpd of JAX's bf16, its gradients rel 2e-2 of JAX's bf16 by norm
(five bf16 unit roundoffs, 2^-8 each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import bench as jbench
from inverse_flow_tpu import layers as jl
from inverse_flow_tpu.layers import Flow as JaxFlow
from inverse_flow_tpu.models.glow import build_glow as jax_build_glow
from inverse_flow_tpu_torch import layers as tl
from inverse_flow_tpu_torch.bridge import params_from_jax, params_to_jax
from inverse_flow_tpu_torch.data.loader import ArrayLoader
from inverse_flow_tpu_torch.experiments import bench_configs
from inverse_flow_tpu_torch.layers import Flow
from inverse_flow_tpu_torch.models.glow import build_glow
from inverse_flow_tpu_torch.train.config import ExperimentConfig
from inverse_flow_tpu_torch.train.experiment import Experiment
from test_torch_baselines import _rel, _t
from test_torch_selfnorm import _grad_tree

BF16_ULP = 2.0 ** -7
SIZES = [(4, 8, 8), (12, 16, 16)]


def _layer_params(layer, scale, seed):
    """JAX's init of ``layer`` with every leaf moved by ``scale`` normal
    noise from a numpy seed."""
    p, _ = layer.init(jax.random.PRNGKey(seed), layer.input_size)
    rs = np.random.RandomState(seed + 1)
    return {k: np.asarray(v) + scale * rs.randn(*v.shape).astype(np.float32)
            for k, v in p.items()}


def _pair(cls_name, size, dtype, scale=0.05, seed=0, width=32):
    """The JAX layer and the port's, in ``dtype``, on the same params."""
    jlayer = getattr(jl, cls_name)(size, width=width, compute_dtype=dtype)
    tlayer = getattr(tl, cls_name)(size, width=width, compute_dtype=dtype,
                                   device="cpu")
    p = _layer_params(jlayer, scale, seed)
    params_from_jax(Flow(None, [tlayer]), [p])
    return jlayer, tlayer, p


def _x(size, b=4, seed=2):
    return np.random.RandomState(seed).randn(b, *size).astype(np.float32)


@pytest.mark.parametrize("size", SIZES)
def test_bf16_net_matches_jax_and_float32(size):
    """The coupling net's output h in bf16, port and JAX, against each
    other and against the float32 net on the same params: the bf16
    results are float32 tensors."""
    x1 = _x(size)[:, :size[0] // 2]
    outs = {}
    for dtype in ("float32", "bfloat16"):
        jlayer, tlayer, p = _pair("Coupling", size, dtype)
        jh = np.asarray(jlayer._net({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x1)))
        th = tlayer._net(tlayer.own_params(), _t(x1))
        assert th.dtype == torch.float32
        outs[dtype] = (th.detach().numpy(), jh)
    ref = outs["float32"][0]
    np.testing.assert_allclose(ref, outs["float32"][1], rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    ours, theirs = outs["bfloat16"]
    scale = BF16_ULP * np.abs(ref).max()
    assert np.abs(ours - theirs).max() <= 8 * scale
    for h in (ours, theirs):
        assert np.abs(h - ref).max() <= 16 * scale
        assert np.abs(h - ref).max() > 0       # bf16 did round


@pytest.mark.parametrize("cls_name", ["Coupling", "SplitPrior"])
def test_bf16_layers_match_jax(cls_name):
    """The layer's output and ldj (SplitPrior's includes the factored-out
    half's log-prob) in bf16, port against JAX."""
    size = (12, 16, 16)
    jlayer, tlayer, p = _pair(cls_name, size, "bfloat16")
    x = _x(size)
    jz, jldj = jlayer.forward({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x))
    with torch.no_grad():
        tz, tldj = tlayer(_t(x))
    for a, b in ((tz, jz), (tldj, jldj)):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-2,
                                   atol=1e-2 * np.abs(b).max())


@pytest.mark.parametrize("cls_name", ["Coupling", "SplitPrior"])
def test_policies_identical_at_zero_init(cls_name):
    """At init (w3, b3, logs3 zero) the net's output is exactly zero in
    either dtype, so bf16 and float32 give the same z and ldj bit for
    bit."""
    size = (4, 8, 8)
    gen = torch.Generator().manual_seed(0)
    f32 = getattr(tl, cls_name)(size, width=32, generator=gen, device="cpu")
    bf = getattr(tl, cls_name)(size, width=32, compute_dtype="bf16",
                               device="cpu")
    bf.load_state_dict(f32.state_dict())
    x = _t(_x(size))
    with torch.no_grad():
        for a, b in zip(f32(x), bf(x)):
            assert torch.equal(a, b)


def test_bf16_round_trip():
    """Forward and inverse run the net on the same x1, so its output is
    bitwise the same both ways and the inverse undoes the affine map up
    to float32 rounding."""
    size = (4, 8, 8)
    _, layer, _ = _pair("Coupling", size, "bfloat16")
    x = _t(_x(size, b=8))
    with torch.no_grad():
        z, ldj = layer(x)
        back = layer.inverse(z)
        p = layer.own_params()
        assert torch.equal(layer._net(p, x[:, :2]), layer._net(p, z[:, :2]))
    assert z.dtype == ldj.dtype == torch.float32
    assert ((back - x).abs() <= 1e-6 * x.abs().clamp(min=1.0)).all()


def test_bf16_ldj_delta_small_at_realistic_scale():
    """JAX's bound on the per-layer ldj delta of the policy, in bpd of the
    layer's input, at weight noise 0.01."""
    size = (4, 8, 8)
    _, f32, p = _pair("Coupling", size, "float32", scale=0.01, seed=3)
    bf = tl.Coupling(size, width=32, compute_dtype="bfloat16", device="cpu")
    bf.load_state_dict(f32.state_dict())
    x = _t(_x(size, b=8, seed=4))
    with torch.no_grad():
        d = (f32(x)[1] - bf(x)[1]).abs().max().item()
    assert d / (np.log(2.0) * np.prod(size)) < 2e-3


def test_float32_path_is_the_parent_formula():
    """``compute_dtype="float32"`` keeps the parent's net bit for bit: b3
    folded into the last conv, no cast."""
    size = (12, 16, 16)
    _, layer, _ = _pair("Coupling", size, "float32")
    p = layer.own_params()
    x1 = _t(_x(size))[:, :6]
    h = F.relu(F.conv2d(x1, p["w1"], padding=1))
    h = F.relu(F.conv2d(h, p["w2"]))
    h = F.conv2d(h, p["w3"], p["b3"], padding=1)
    h = h * torch.exp(p["logs3"] * layer.logscale_factor).reshape(
        1, -1, 1, 1)
    assert torch.equal(layer._net(p, x1), h)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_net_gives_the_same_gradients(dtype):
    """``remat_net`` recomputes the net in the backward: the gradients are
    the same as without it, bit for bit, in either dtype."""
    size = (4, 8, 8)
    _, a, _ = _pair("Coupling", size, dtype)
    b = tl.Coupling(size, width=32, compute_dtype=dtype, remat_net=True,
                    device="cpu")
    b.load_state_dict(a.state_dict())
    x = _t(_x(size))
    grads = []
    for layer in (a, b):
        z, ldj = layer(x)
        grads.append(torch.autograd.grad((z ** 2).sum() - ldj.sum(),
                                         list(layer.parameters())))
    for g, h in zip(*grads):
        assert torch.equal(g, h)


# ---------------------------------------------------------------------------
# A reduced imagenet32 model with bf16 couplings
# ---------------------------------------------------------------------------

SIZE = (3, 16, 16)
MODEL_KW = dict(step_kind="inv_flow_unit", num_blocks=2, block_size=2,
                coupling_width=16, activation="SLR")
B = 4
ZERO_INIT = ("w3", "b3", "logs3")


@pytest.fixture(scope="module")
def bf16_model():
    """JAX's bf16 model, the port's in bf16 and in float32, on JAX's
    params after ActNorm's data init on a dequantized batch, with every
    coupling's zero-initialized ``w3``, ``b3`` and ``logs3`` then moved by
    0.05 noise; the batch."""
    jflow = jax_build_glow(SIZE, coupling_dtype="bfloat16", **MODEL_KW)
    jparams = jax.device_get(jax.jit(lambda k: jflow.init(k, SIZE)[0])(
        jax.random.PRNGKey(0)))
    rs = np.random.RandomState(1)
    y = (rs.randint(0, 256, (B,) + SIZE)
         + rs.uniform(0.0, 1.0, (B,) + SIZE)).astype(np.float32)
    # ActNorm's data init on the batch, in float32 (the init pass of a
    # zero-output coupling is the same in either dtype)
    jsub = JaxFlow(jflow.base_distribution, jflow.layers[1:])
    jparams = [jparams[0]] + list(jax.device_get(jax.jit(jsub.data_init)(
        jparams[1:], jnp.asarray(y))))
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.05 * rs.randn(*a.shape).astype(np.float32)
        if path[-1].key in ZERO_INIT else a, jparams)
    flows = {}
    for dtype in ("bfloat16", "float32"):
        flows[dtype] = build_glow(SIZE, coupling_dtype=dtype, **MODEL_KW,
                                  device="cpu")
        params_from_jax(flows[dtype], jparams)
    return jflow, jparams, flows, y


def _bpd(logp):
    return -np.asarray(logp, np.float64) / (np.log(2.0) * np.prod(SIZE))


def test_bf16_model_logp_and_gradients_match_jax(bf16_model):
    """log p(x) of the bf16 model after dequantization against JAX's bf16
    model and against the port's float32 one, in bpd; the gradients of the
    mean -log p against ``jax.grad`` of JAX's bf16 model."""
    jflow, jparams, flows, y = bf16_model
    jsub = JaxFlow(jflow.base_distribution, jflow.layers[1:])
    subs = {k: Flow(f.base_distribution, f.layers[1:])
            for k, f in flows.items()}
    ref = jax.jit(lambda p: jsub.forward(p, y)[1])(jparams[1:])
    refs = jax.jit(jax.grad(lambda p: -jnp.mean(jsub.forward(p, y)[1])))(
        jparams[1:])
    logp = subs["bfloat16"](_t(y))[1]
    with torch.no_grad():
        logp32 = subs["float32"](_t(y))[1]
    ours = _bpd(logp.detach().numpy())
    assert np.abs(ours - _bpd(ref)).max() <= 1e-3
    assert np.abs(ours - _bpd(logp32.numpy())).max() <= 2e-3
    assert not np.array_equal(logp.detach().numpy(), logp32.numpy())
    (-logp.mean()).backward()
    grads = _grad_tree(subs["bfloat16"])
    for (path, r), a in zip(jax.tree_util.tree_leaves_with_path(refs),
                            jax.tree_util.tree_leaves(grads)):
        assert _rel(a, r) <= 2e-2, path


def test_bf16_model_trains(bf16_model):
    """Data init and 3 Adam steps of the bf16 model through
    ``Experiment``: finite losses that move, params float32."""
    _, _, flows, _ = bf16_model
    flow = build_glow(SIZE, coupling_dtype="bfloat16", **MODEL_KW,
                      device="cpu")
    flow.load_state_dict(flows["bfloat16"].state_dict())
    data = np.random.RandomState(2).randint(0, 256, (3 * B,) + SIZE).astype(
        np.float32)
    loader = ArrayLoader(data, B, shuffle=True, seed=0)
    cfg = ExperimentConfig(lr=1e-3, batch_size=B, warmup_epochs=0,
                           scheduler_name="None", add_recon_grad=False,
                           plot_recon=False, save_images=False, seed=0)
    exp = Experiment(flow, loader, loader, loader, cfg, device="cpu")
    exp.maybe_data_init(data[:B])
    losses = [exp.train_step(torch.from_numpy(b)) for b in loader]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert len(set(losses)) == 3
    assert all(p.dtype == torch.float32 for p in flow.parameters())


# ---------------------------------------------------------------------------
# bench.py's configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jbench.CONFIGS))
def test_bench_configs_match_jax(name):
    """Every name of ``bench.py``'s CONFIGS: the same data shape and
    batch, and a model whose parameters carry the JAX tree's names and
    shapes (JAX's by ``eval_shape``); the bf16 names build bf16 coupling
    nets and ``imagenet32_b4096`` checkpoints every step."""
    assert set(bench_configs.CONFIGS) == set(jbench.CONFIGS)
    jflow, jshape, jbatch = jbench.CONFIGS[name]()
    flow, shape, batch = bench_configs.build(
        name, device="cpu", generator=torch.Generator().manual_seed(0))
    assert (tuple(shape), batch) == (tuple(jshape), jbatch)
    shapes = jax.eval_shape(lambda k: jflow.init(k, jshape)[0],
                            jax.random.PRNGKey(0))
    back = params_to_jax(flow)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(shapes))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(shapes)):
        assert a.shape == b.shape
    bf16 = "bf16" in name or name in ("imagenet32_b1024", "imagenet32_b4096")
    assert all(m.compute_dtype == (torch.bfloat16 if bf16 else torch.float32)
               for m in flow.modules() if isinstance(m, tl.Coupling))
    assert all(m.remat == (name == "imagenet32_b4096")
               for m in flow.modules() if isinstance(m, tl.RepeatedBlock))
    with pytest.raises(KeyError):
        bench_configs.build("no_such_config", device="cpu")
