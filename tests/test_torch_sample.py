"""The sampling direction against the JAX package, on the CPU: every layer
inverse, ``Flow.sample`` with JAX's own draws injected, ``reconstruct``,
``Experiment.sample``/``plot_recon`` and the image grid.

Each layer case of ``test_torch_layers.py`` builds the JAX layer, carries
its params over and runs both inverses on the same numpy input.
Tolerances: layer inverses rtol 1e-5 with atol 1e-5 (elementwise maps and
masked convs; 1e-4 after a coupling net or a repeated block), and every
round trip ``inverse(forward(x))`` within 1e-4; the reduced models'
samples before the final floor within rtol 1e-4 by norm (float32 round-off
through up to 20 inverse layers), and the floored images equal on at
least 99.9% of their pixels (a pixel whose value lies within that
round-off of an integer may floor either way).
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_flow_tpu import distributions as jd
from inverse_flow_tpu import layers as jl
from inverse_flow_tpu.layers import Flow as JaxFlow
from inverse_flow_tpu.layers import splines as js
from inverse_flow_tpu.models.glow import build_glow as jax_build_glow
from inverse_flow_tpu.utils import imaging as jimaging
from inverse_flow_tpu_torch import distributions as td
from inverse_flow_tpu_torch import layers as tl
from inverse_flow_tpu_torch.bridge import params_from_jax
from inverse_flow_tpu_torch.data.loader import ArrayLoader
from inverse_flow_tpu_torch.layers import Flow
from inverse_flow_tpu_torch.layers import splines as ts
from inverse_flow_tpu_torch.models.glow import build_glow
from inverse_flow_tpu_torch.ops import fused_chain as tfc
from inverse_flow_tpu_torch.train.config import ExperimentConfig
from inverse_flow_tpu_torch.train.experiment import Experiment
from inverse_flow_tpu_torch.utils import imaging as timaging

from test_torch_layers import B, CASES, _input, _load, _randomize

SIZE = (1, 28, 28)
N = 16

# the layer cases whose inverse ends in a coupling net or a block of steps
LOOSE = {"coupling", "repeated_block", "inv_flow_unit"}
INVERSE_CASES = dict(CASES, inv_flow_unit=lambda: (
    jl.InvFlowUnit(8, (3, 3)), tl.InvFlowUnit(8, (3, 3)), (8, 7, 7)))
del INVERSE_CASES["split_prior"]          # takes its draw: a test of its own


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("name", list(INVERSE_CASES))
def test_layer_inverse_matches_jax(name):
    """inverse(z) against JAX's on the layer's forward output z, and the
    round trip back to x."""
    jlayer, tlayer, shape = INVERSE_CASES[name]()
    jparams, _ = jlayer.init(jax.random.PRNGKey(0), shape)
    jparams = _randomize(jparams, 1)
    _load(tlayer, jparams)
    x = _input(name, shape)
    z = np.array(jlayer.forward(jparams, jnp.asarray(x))[0])
    xj = np.asarray(jax.jit(jlayer.inverse)(jparams, jnp.asarray(z)))
    with torch.no_grad():
        xt = tlayer.inverse(torch.from_numpy(z))
        back = tlayer.inverse(tlayer(torch.from_numpy(x))[0])
    atol = 1e-4 if name in LOOSE else 1e-5
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-4, atol=1e-4)


def test_dequantization_inverse_floors():
    x = _input("normalization", (1, 8, 8))
    u = np.random.RandomState(1).uniform(0, 1, x.shape).astype(np.float32)
    jlayer = jl.Dequantization(jd.UniformDistribution((1, 8, 8)))
    tlayer = tl.Dequantization(td.UniformDistribution((1, 8, 8)))
    ref = np.asarray(jlayer.inverse({}, jnp.asarray(x + u)))
    out = tlayer.inverse(tlayer(torch.from_numpy(x),
                                noise=torch.from_numpy(u))[0])
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), x)


def test_split_prior_inverse_with_injected_draw():
    """SplitPrior's inverse on JAX's own draw of the factored-out half;
    the round trip with the half that the forward factored out; without a
    generator or a draw it raises, as JAX does without an rng."""
    jlayer, tlayer, shape = CASES["split_prior"]()
    jparams = _randomize(jlayer.init(jax.random.PRNGKey(0), shape)[0], 1)
    _load(tlayer, jparams)
    x = _input("split_prior", shape)
    z = np.array(jlayer.forward(jparams, jnp.asarray(x))[0])
    rng = jax.random.PRNGKey(2)
    xj = np.asarray(jlayer.inverse(jparams, jnp.asarray(z), rng=rng))
    draw = np.array(jlayer.base.sample(rng, B)[0])
    full = tl.Coupling.forward_with(tlayer, tlayer.own_params(),
                                    torch.from_numpy(x))[0]
    with torch.no_grad():
        xt = tlayer.inverse(torch.from_numpy(z), noise=torch.from_numpy(draw))
        back = tlayer.inverse(tlayer(torch.from_numpy(x))[0],
                              noise=full[:, shape[0] // 2:])
        drawn = tlayer.inverse(torch.from_numpy(z),
                               torch.Generator().manual_seed(0))
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-4, atol=1e-4)
    assert drawn.shape == x.shape and torch.isfinite(drawn).all()
    with pytest.raises(ValueError):
        tlayer.inverse(torch.from_numpy(z))


@pytest.mark.parametrize("tail_bound", [3.0, 20.0])
def test_spline_inverse_tails_and_knots_match_jax(tail_bound):
    """The RQ-spline inverse on the knots of its output grid (cumheights,
    the last with JAX's eps), on both sides of +-tail_bound (identity
    tails) and between, against JAX's; the forward undoes it."""
    rs = np.random.RandomState(5)
    w, h = rs.randn(2, 1, 5).astype(np.float32)
    d = rs.randn(1, 4).astype(np.float32)
    knots = np.concatenate([[-tail_bound], -tail_bound + 2 * tail_bound
                            * np.cumsum(np.exp(h[0]) / np.exp(h[0]).sum())])
    edges = [tail_bound, -tail_bound, 0.999999 * tail_bound, 1.02 * tail_bound,
             -1.02 * tail_bound, 1.5 * tail_bound, -3 * tail_bound]
    x = np.concatenate([knots, edges, tail_bound * rs.uniform(-1, 1, 40)])
    x = x.astype(np.float32)
    args = [np.broadcast_to(a, x.shape + a.shape[1:]).copy()
            for a in (w, h, d)]
    zj, lj = js.unconstrained_rational_quadratic_spline(
        jnp.asarray(x), *map(jnp.asarray, args), inverse=True,
        tail_bound=tail_bound)
    targs = [torch.from_numpy(a) for a in args]
    zt, lt = ts.unconstrained_rational_quadratic_spline(
        torch.from_numpy(x), *targs, inverse=True, tail_bound=tail_bound)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-5,
                               atol=1e-5 * tail_bound)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)
    outside = np.abs(x) > tail_bound
    np.testing.assert_array_equal(zt.numpy()[outside], x[outside])
    back, _ = ts.unconstrained_rational_quadratic_spline(
        zt, *targs, tail_bound=tail_bound)
    np.testing.assert_allclose(back.numpy(), x, rtol=0,
                               atol=1e-5 * tail_bound)


def test_inverse_contract_and_not_ported_inverses():
    """The default inverse raises NotImplementedError naming the layer;
    every layer of the ported models has its own, SmoothLeakyRelu's
    Newton inverse included, so a reduced imagenet32 model samples."""
    class NoInverse(tl.FlowLayer):
        pass
    with pytest.raises(NotImplementedError, match="NoInverse"):
        NoInverse().inverse(torch.zeros(1, 3, 4, 4))
    flow = build_glow((3, 8, 8), step_kind="inv_flow_unit", num_blocks=2,
                      block_size=1, coupling_width=4, activation="SLR",
                      device="cpu")
    x = flow.sample(2, torch.Generator().manual_seed(0))
    assert x.shape == (2, 3, 8, 8) and torch.isfinite(x).all()


def test_gaussian_prior_sample_and_grid_match_jax(tmp_path):
    """GaussianPrior.sample gives (x, log p(x)), as JAX's; the image grid
    and its PNG bytes equal JAX's on a seeded grid."""
    x, lp = td.GaussianPrior((2, 3, 3)).sample(
        torch.Generator().manual_seed(0), 4)
    assert x.shape == (4, 2, 3, 3)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jd.GaussianPrior(
        (2, 3, 3)).log_prob(jnp.asarray(x.numpy()))), rtol=1e-6)
    rs = np.random.RandomState(6)
    for shape, nrow in (((13, 1, 7, 5), 4), ((3, 3, 6, 6), 10)):
        img = rs.uniform(-0.1, 1.1, shape).astype(np.float32)
        np.testing.assert_array_equal(timaging.make_grid(img, nrow),
                                      jimaging.make_grid(img, nrow))
        timaging.save_image_grid(img, tmp_path / "t.png", nrow=nrow)
        jimaging.save_image_grid(img, tmp_path / "j.png", nrow=nrow)
        assert (tmp_path / "t.png").read_bytes() == (
            tmp_path / "j.png").read_bytes()


# ---------------------------------------------------------------------------
# Flow.sample of the reduced ff and flagship models, with JAX's draws
# ---------------------------------------------------------------------------

MODELS = {"ff": dict(step_kind="ff"), "flagship": {}}


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    """JAX's init and data init of the reduced model (L=2 x K=2, width 16,
    (1, 28, 28)) on one batch, carried into the port."""
    kw = dict(num_blocks=2, block_size=2, coupling_width=16,
              **MODELS[request.param])
    jflow = jax_build_glow(SIZE, **kw)
    jparams = jax.jit(lambda key: jflow.init(key, SIZE)[0])(
        jax.random.PRNGKey(0))
    rs = np.random.RandomState(7)
    x = (rs.randint(0, 256, (N,) + SIZE)
         + rs.uniform(0, 1, (N,) + SIZE)).astype(np.float32)
    jsub = JaxFlow(jflow.base_distribution, jflow.layers[1:])
    jparams = [jparams[0]] + list(jax.jit(jsub.data_init)(
        jparams[1:], jnp.asarray(x)))
    jparams = jax.device_get(jparams)
    tflow = build_glow(SIZE, **kw, device="cpu")
    params_from_jax(tflow, jparams)
    return jflow, jparams, tflow


def _jax_draws(jflow, rng, n):
    """The draws of JAX's ``Flow.sample(params, rng, n)``: z from the
    first split of ``rng``, each SplitPrior's half from its layer rng."""
    rng, base_rng = jax.random.split(rng)
    draws = {"base": jflow.base_distribution.sample(base_rng, n)[0]}
    rngs = jflow._layer_rngs(rng, salt=1)
    for i, layer in enumerate(jflow.layers):
        if isinstance(layer, jl.SplitPrior):
            draws[i] = layer.base.sample(rngs[i], n)[0]
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def _sub(flow, cls):
    return cls(flow.base_distribution, flow.layers[1:])


def test_flow_sample_matches_jax(model):
    """``Flow.sample`` on JAX's draws: the output before the final floor
    (the flows without their Dequantization) and the floored images; no
    kernel launch on the CPU; no autograd state."""
    jflow, jparams, tflow = model
    rng = jax.random.PRNGKey(3)
    jsub, tsub = _sub(jflow, JaxFlow), _sub(tflow, Flow)
    pre_j = np.asarray(jax.jit(lambda p, r: jsub.sample(p, r, N))(
        jparams[1:], rng))
    before = tfc.chain_phases.launches
    pre_t = tsub.sample(N, noise=_jax_draws(jsub, rng, N))
    assert tfc.chain_phases.launches == before
    assert pre_t.shape == (N,) + SIZE and not pre_t.requires_grad
    assert np.isfinite(pre_t.numpy()).all() and np.ptp(pre_j) > 50
    assert _rel(pre_t.numpy(), pre_j) <= 1e-4

    img_j = np.asarray(jax.jit(lambda p, r: jflow.sample(p, r, N))(
        jparams, rng))
    img_t = tflow.sample(N, noise=_jax_draws(jflow, rng, N)).numpy()
    np.testing.assert_array_equal(img_t, np.floor(img_t))
    assert (img_t == img_j).mean() >= 0.999


def test_flow_sample_draws_and_repeated_block_round_trip(model):
    """Draws from a seeded generator repeat; each RepeatedBlock's inverse
    undoes its forward; reconstruct through a SplitPrior is lossy, as in
    JAX, but returns images of the input's shape."""
    _, _, tflow = model
    a = tflow.sample(3, torch.Generator().manual_seed(4))
    b = tflow.sample(3, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and a.shape == (3,) + SIZE
    rs = np.random.RandomState(8)
    for i in (5, 8):
        block = tflow.layers[i]
        c = 4 * 2 ** (i // 8)
        h = 14 // 2 ** (i // 8)
        x = torch.from_numpy(rs.randn(4, c, h, h).astype(np.float32))
        with torch.no_grad():
            back = block.inverse(block(x)[0])
        assert _rel(back.numpy(), x.numpy()) <= 1e-4
    x = torch.from_numpy(rs.randint(0, 256, (2,) + SIZE).astype(np.float32))
    r = tflow.reconstruct(x, torch.Generator().manual_seed(5))
    assert r.shape == x.shape and torch.isfinite(r).all()


def test_reconstruct_without_split_prior_is_exact():
    """A flow with no SplitPrior reconstructs its integer input (floor of
    x + u after the round trip), as the JAX package's does."""
    flow = build_glow(SIZE, num_blocks=1, block_size=2, coupling_width=8,
                      split_prior=False, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(9).randint(
        0, 256, (4,) + SIZE).astype(np.float32))
    flow.data_init(x, torch.Generator().manual_seed(1))
    r = flow.reconstruct(x, torch.Generator().manual_seed(2))
    assert (r == x).float().mean().item() >= 0.999


def test_experiment_sample_and_plot_recon(tmp_path, model):
    """``Experiment.sample`` logs the one-image latencies (trimmed mean
    and std), writes the grid of ``n_samples`` images and returns them;
    ``plot_recon`` writes x, its reconstruction and their difference; a
    write that fails is logged as a warning and the run goes on."""
    _, _, tflow = model
    metrics = tmp_path / "m.jsonl"
    cfg = ExperimentConfig(n_samples=6, sample_dir=str(tmp_path / "s"),
                           metrics_path=str(metrics), seed=0)
    data = np.zeros((4,) + SIZE, np.float32)
    loader = ArrayLoader(data, 4)
    exp = Experiment(copy.deepcopy(tflow), loader, loader, loader, cfg,
                     device="cpu")
    exp._data_initialized = True
    x = exp.sample(3)
    assert x.shape == (6,) + SIZE and torch.isfinite(x).all()
    assert (tmp_path / "s" / "3.png").read_bytes().startswith(b"\x89PNG")
    assert not (tmp_path / "s" / "3_trueinv.png").exists()
    names = [json.loads(line)["name"] for line in metrics.read_text()
             .splitlines()]
    assert "summary/Sample Time Mean" in names
    assert "summary/Sample Time Std" in names
    assert exp.sample_time.mean > 0

    xhat = exp.plot_recon(np.full((2,) + SIZE, 100.0, np.float32), 3)
    assert xhat.shape == (2,) + SIZE
    for f in ("3_x.png", "3_xrecon.png", "3_recon_diff.png"):
        assert (tmp_path / "s" / f).exists()

    (tmp_path / "blocked").write_text("")
    exp.cfg = cfg.replace(sample_dir=str(tmp_path / "blocked"),
                          log_timing=False, sample_true_inv=True)
    assert exp.sample(4).shape == (6,) + SIZE
    warnings = [json.loads(line) for line in metrics.read_text()
                .splitlines() if json.loads(line)["name"] == "Warning"]
    assert len(warnings) == 2 and "image save failed" in warnings[0]["value"]
