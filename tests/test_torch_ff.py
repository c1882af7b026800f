"""The FincFlow slice (``PaddedConv2d``, ``FincFlowUnit``, the grouped
expansion, the grouped ``InvFlow`` and the ``ff_glow_mnist`` model) against
the JAX package, on the CPU.

Inputs come from numpy with a seed; weights cross with ``params_from_jax``.
On a CPU tensor the port's chain runs its plain version; the JAX unit's
inverse runs its default exact grouped solve, and at one shape its fused
Pallas path in interpret mode.

Tolerances: the forward (a masked conv) atol 1e-5; the inverse (a solve
whose outputs reach about 10) atol 1e-4, as are the round trips; the
grouped ``InvFlow`` as the chain tests hold ``InvFlow``: y within 1e-5 *
max(1, max|y|), dW within 1e-4 * max|dW|; the expansion exactly; the
reduced model's log p(x) rtol 1e-5 and its Adam losses rel 2e-3, as in
``test_torch_unit.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_flow_tpu import layers as jl
from inverse_flow_tpu.data.loader import ArrayLoader as JaxLoader
from inverse_flow_tpu.layers import Flow as JaxFlow
from inverse_flow_tpu.layers.padded_conv import (FincFlowUnit as JaxFinc,
                                                 PaddedConv2d as JaxPadded)
from inverse_flow_tpu.models.glow import build_glow as jax_build_glow
from inverse_flow_tpu.ops import fused_chain as jfc
from inverse_flow_tpu.ops import inv_conv as jic
from inverse_flow_tpu.train.config import ExperimentConfig as JaxConfig
from inverse_flow_tpu.train.experiment import Experiment as JaxExperiment
from inverse_flow_tpu_torch import layers as tl
from inverse_flow_tpu_torch.bridge import params_from_jax, params_to_jax
from inverse_flow_tpu_torch.data.loader import ArrayLoader
from inverse_flow_tpu_torch.layers import Flow
from inverse_flow_tpu_torch.models.glow import build_glow
from inverse_flow_tpu_torch.ops import fused_chain as tfc
from inverse_flow_tpu_torch.ops import inv_conv as tic
from inverse_flow_tpu_torch.train.config import ExperimentConfig
from inverse_flow_tpu_torch.train.experiment import Experiment

from test_torch_kernel import _tol

# the reduced ff_glow_mnist model: L=2 x K=2, width 16; its FincFlow units
# run at the full model's shapes, (4, 14, 14) and (8, 7, 7)
MODEL_KW = dict(step_kind="ff", num_blocks=2, block_size=2,
                coupling_width=16)
SIZE = (1, 28, 28)
B = 8
FF_SHAPES = [(4, 14, 14), (8, 7, 7), (16, 4, 4)]
FF_IDS = ["4x14x14", "8x7x7", "16x4x4"]


def _load(tlayer, jparams):
    params_from_jax(Flow(None, [tlayer]), [jparams])


def _finc_pair(chw, solver="exact", seed=0):
    """The JAX unit and the port's with JAX's init (normal(0, 0.05)) plus
    0.1 * randn: solves well away from the identity."""
    c = chw[0]
    jlayer = JaxFinc(c, solver=solver)
    jparams, _ = jlayer.init(jax.random.PRNGKey(seed), chw)
    rs = np.random.RandomState(seed + 1)
    jparams = {"ws": [np.asarray(w) + 0.1 * rs.randn(*w.shape).astype(
        np.float32) for w in jparams["ws"]]}
    tlayer = tl.FincFlowUnit(c, solver=solver)
    _load(tlayer, jparams)
    return jlayer, jparams, tlayer


def _x(chw, b=3, seed=2):
    return np.random.RandomState(seed).randn(b, *chw).astype(np.float32)


@pytest.mark.parametrize("chw", FF_SHAPES, ids=FF_IDS)
def test_finc_flow_unit_forward_matches_jax(chw):
    jlayer, jparams, tlayer = _finc_pair(chw)
    x = _x(chw)
    zj, lj = jax.jit(jlayer.forward)(jparams, jnp.asarray(x))
    with torch.no_grad():
        zt, lt = tlayer(torch.from_numpy(x))
    assert not lt.any() and not np.asarray(lj).any()
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=1e-5)


@pytest.mark.parametrize("chw", FF_SHAPES, ids=FF_IDS)
def test_finc_flow_unit_inverse_matches_jax(chw):
    """The level-2 inverse (the grouped solve on the chain, the kernel's
    plain version here) against JAX's exact grouped solve; and both round
    trips."""
    jlayer, jparams, tlayer = _finc_pair(chw)
    z = _x(chw, seed=3)
    xj = np.asarray(jax.jit(jlayer.inverse)(jparams, jnp.asarray(z)))
    before = tfc.chain_phases.launches
    with torch.no_grad():
        xt = tlayer.inverse(torch.from_numpy(z))
        back = tlayer(xt)[0]
        again = tlayer.inverse(tlayer(torch.from_numpy(z))[0])
    assert tfc.chain_phases.launches == before      # CPU: no kernel launch
    # far from the identity: the solve moves z by a good fraction of itself
    assert np.linalg.norm(xj - z) > 0.2 * np.linalg.norm(z)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(back.numpy(), z, rtol=0, atol=1e-4)
    np.testing.assert_allclose(again.numpy(), z, rtol=0, atol=1e-4)


def test_finc_flow_unit_inverse_matches_jax_fused_interpret(monkeypatch):
    """Against the JAX unit's ``solver='fused'`` path: the Pallas chain
    kernel in interpret mode on the dense block-diagonal expansion."""
    monkeypatch.setattr(jfc, "_INTERPRET", True)
    chw = (8, 6, 6)
    jlayer, jparams, tlayer = _finc_pair(chw, solver="fused", seed=4)
    assert jfc.select_fused("fused", (2,) + chw, (3, 3), ("TL",), groups=4)
    z = _x(chw, b=2, seed=5)
    xj = np.asarray(jlayer.inverse(jparams, jnp.asarray(z)))
    with torch.no_grad():
        xt = tlayer.inverse(torch.from_numpy(z))
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-4)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_expand_grouped_kernel_matches_jax(groups):
    """The dense expansion equals JAX's exactly, and its gradient lands on
    the group blocks only: the kernel's gradient read back through the
    expansion is the dense gradient's diagonal blocks."""
    rs = np.random.RandomState(6)
    w = rs.randn(8, 8 // groups, 3, 3).astype(np.float32)
    ref = np.asarray(jfc.expand_grouped_kernel(jnp.asarray(w), groups))
    wt = torch.from_numpy(w).requires_grad_()
    dense = tfc.expand_grouped_kernel(wt, groups)
    np.testing.assert_array_equal(dense.detach().numpy(), ref)
    g = torch.from_numpy(rs.randn(8, 8, 3, 3).astype(np.float32))
    (dense * g).sum().backward()
    cg = 8 // groups
    want = torch.cat([g[i:i + cg, i:i + cg] for i in range(0, 8, cg)])
    assert torch.equal(wt.grad, want)


def test_masked_conv_grouped_and_dense_operator_match_jax():
    """``masked_conv_apply`` and ``dense_operator`` with groups=4 against
    JAX's, and the dense operator of the expanded kernel is the grouped
    one."""
    rs = np.random.RandomState(7)
    w = tic.apply_mask(torch.from_numpy(rs.randn(2, 2, 3, 3).astype(
        np.float32)))
    w_eff = torch.cat([w, 0.5 * w, -w, 2 * w])            # (8, 2, 3, 3)
    y = rs.randn(2, 8, 5, 5).astype(np.float32)
    ours = tic.masked_conv_apply(torch.from_numpy(y), w_eff, 4)
    ref = jic.masked_conv_apply(jnp.asarray(y), jnp.asarray(w_eff.numpy()), 4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    dense = tic.dense_operator(w_eff, 8, 5, 5, groups=4)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jic.dense_operator(
        jnp.asarray(w_eff.numpy()), 8, 5, 5, groups=4)), atol=1e-7)
    assert torch.equal(dense, tic.dense_operator(
        tfc.expand_grouped_kernel(w_eff, 4), 8, 5, 5))


@pytest.mark.parametrize("order", ["TL", "TR", "BL", "BR"])
def test_padded_conv_matches_jax(order):
    """PaddedConv2d both ways: the masked conv forward, the solve inverse
    (through the chain with the order's flips absorbed)."""
    jlayer = JaxPadded(4, (3, 3), order=order)
    jparams, _ = jlayer.init(jax.random.PRNGKey(8), (4, 7, 9))
    tlayer = tl.PaddedConv2d(4, (3, 3), order=order)
    _load(tlayer, jparams)
    x = _x((4, 7, 9), seed=9)
    zj, _ = jlayer.forward(jparams, jnp.asarray(x))
    xj = np.asarray(jlayer.inverse(jparams, jnp.asarray(x)))
    with torch.no_grad():
        zt, lt = tlayer(torch.from_numpy(x))
        xt = tlayer.inverse(torch.from_numpy(x))
    assert not lt.any()
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-4)
    with pytest.raises(ValueError):
        tl.PaddedConv2d(4, order="XX")


@pytest.mark.parametrize("order", ["TL", "BR"])
def test_grouped_inv_flow_matches_jax(order):
    """``InvFlow(c, groups=2)``: the solve through the chain on the
    expanded kernel, its gradients (autograd through the expansion and the
    per-group mask) and its inverse, against JAX's values and
    ``jax.grad``."""
    chw = (8, 7, 7)
    jlayer = jl.InvFlow(8, (3, 3), order=order, groups=2)
    jparams, _ = jlayer.init(jax.random.PRNGKey(10), chw)
    rs = np.random.RandomState(11)
    jparams = {"w": np.asarray(jparams["w"]) + 0.1 * rs.randn(
        *jparams["w"].shape).astype(np.float32)}
    tlayer = tl.InvFlow(8, (3, 3), order=order, groups=2)
    assert tlayer.w.shape == (8, 4, 3, 3)
    _load(tlayer, jparams)
    x = _x(chw, seed=12)
    r = rs.randn(*x.shape).astype(np.float32)

    def scalar(p, a):
        return jnp.sum(jlayer.forward(p, a)[0] * r)

    yj = np.asarray(jlayer.forward(jparams, jnp.asarray(x))[0])
    gp, gx = jax.grad(scalar, argnums=(0, 1))(jparams, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, ldj = tlayer(xt)
    (y * torch.from_numpy(r)).sum().backward()
    assert not ldj.any()
    assert np.abs(y.detach().numpy() - yj).max() <= _tol(yj)
    gx = np.asarray(gx)
    assert np.abs(xt.grad.numpy() - gx).max() <= _tol(gx)
    gw = np.asarray(gp["w"])
    assert np.abs(tlayer.w.grad.numpy() - gw).max() <= 1e-4 * np.abs(gw).max()
    xj = np.asarray(jlayer.inverse(jparams, jnp.asarray(x)))
    with torch.no_grad():
        xi = tlayer.inverse(torch.from_numpy(x))
        np.testing.assert_allclose(xi.numpy(), xj, rtol=0, atol=1e-5)
        np.testing.assert_allclose(tlayer(xi)[0].numpy(), x, rtol=0,
                                   atol=1e-4)


def test_finc_flow_unit_solvers_names_and_refusals():
    """'exact', 'fused' and 'auto' are one function; the parameters are
    ``ws.0`` ... ``ws.3`` of the init's scale; channels must split in
    four."""
    gen = torch.Generator().manual_seed(0)
    units = [tl.FincFlowUnit(8, solver=s, generator=gen)
             for s in ("exact", "fused", "auto")]
    assert [n for n, _ in units[0].named_parameters()] == [
        f"ws.{i}" for i in range(4)]
    assert units[0].get_parameter("ws.3").shape == (2, 2, 3, 3)
    w = torch.cat([p.reshape(-1) for p in units[0].parameters()])
    assert 0.03 < w.std().item() < 0.08
    p = units[0].own_params()
    z = torch.from_numpy(_x((8, 7, 7), b=2, seed=13))
    xs = [u.inverse_with(p, z) for u in units]
    for x in xs[1:]:
        assert torch.equal(x, xs[0])
    with pytest.raises(ValueError):
        tl.FincFlowUnit(6)
    with pytest.raises(ValueError):
        tl.FincFlowUnit(8, solver="jacobi")


# ---------------------------------------------------------------------------
# The reduced ff_glow_mnist model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jflow = jax_build_glow(SIZE, **MODEL_KW)
    jparams = jax.device_get(jax.jit(
        lambda key: jflow.init(key, SIZE)[0])(jax.random.PRNGKey(0)))
    tflow = build_glow(SIZE, **MODEL_KW, device="cpu")
    params_from_jax(tflow, jparams)
    rs = np.random.RandomState(14)
    data = (rs.randint(0, 256, (4 * B,) + SIZE)
            + rs.uniform(0.0, 1.0, (4 * B,) + SIZE)).astype(np.float32)
    return jflow, jparams, tflow, data


def test_build_glow_ff_layers(model):
    """The JAX layer list: preprocess, then per level Squeeze and a block
    of [ActNorm, FincFlowUnit, SplineActivation, Coupling], a SplitPrior
    between; the unit's weights stacked (K, C/4, C/4, 3, 3)."""
    jflow, _, tflow, _ = model
    assert [type(l).__name__ for l in tflow.layers] == [
        type(l).__name__ for l in jflow.layers]
    for i, c in ((5, 4), (8, 8)):
        step = tflow.layers[i].steps
        assert [type(l).__name__ for l in step] == [
            "ActNorm", "FincFlowUnit", "SplineActivation", "Coupling"]
        assert step[1].get_parameter("ws.2").shape == (2, c // 4, c // 4, 3,
                                                       3)
        assert tflow.layers[i]._step_params(1)[1]["ws.0"].shape == (
            c // 4, c // 4, 3, 3)


def test_ff_params_round_trip_through_jax_tree(model):
    """``steps.1.ws.i`` cross both ways: the JAX pytree rebuilds with
    ``{"ws": [w0, w1, w2, w3]}`` in each block."""
    _, jparams, tflow, _ = model
    back = params_to_jax(tflow)
    assert len(back[5]["steps"][1]["ws"]) == 4
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jparams))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_reduced_ff_model_logpx_matches_jax(model):
    """Data init, then log p(x) after dequantization on the same x + u:
    the ff training forward reaches no chain."""
    jflow, jparams, tflow, data = model
    x = data[:B]
    jsub = JaxFlow(jflow.base_distribution, jflow.layers[1:])
    jnew = jax.jit(jsub.data_init)(jparams[1:], jnp.asarray(x))
    zj, lpj = jax.jit(jsub.forward)(jnew, jnp.asarray(x))
    tflow = copy.deepcopy(tflow)
    tsub = Flow(tflow.base_distribution, tflow.layers[1:])
    tsub.data_init(torch.from_numpy(x))
    before = tfc.chain_phases.launches
    with torch.no_grad():
        zt, lpt = tsub(torch.from_numpy(x))
    assert tfc.chain_phases.launches == before
    assert zt.shape == (B, 8, 7, 7) and np.isfinite(lpt.numpy()).all()
    np.testing.assert_allclose(lpt.numpy(), np.asarray(lpj), rtol=1e-5)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-4,
                               rtol=0)


def _config(tmp_path, cls):
    """The registry's ``ff_glow_mnist`` config (recon gradients on, weight
    10, clamp 0.01, no scheduler), no warmup and lr 1e-3 so that a few
    steps move the loss."""
    return cls(name="ff", lr=1e-3, batch_size=B, warmup_epochs=0,
               scheduler_name="None", weight_clamp=0.01, modified_grad=True,
               add_recon_grad=True, sym_recon_grad=True,
               recon_loss_weight=10.0, log_timing=False, save_images=False,
               plot_recon=False, metrics_path=str(tmp_path / "m.jsonl"),
               checkpoint_path=str(tmp_path / "c.pkl"), seed=0)


def test_reduced_ff_adam_steps_match_jax(tmp_path, model):
    """JAX's data init, then 4 Adam steps through JAX's
    ``Experiment._train_step`` and the port's ``train_step`` from the same
    weights: with ``add_recon_grad`` and no layer that has a recon loss,
    both add no recon term, and the port does not raise."""
    jfull, jparams, tfull, data = model
    jflow = JaxFlow(jfull.base_distribution, jfull.layers[1:])
    jexp = JaxExperiment(
        jflow, *(JaxLoader(data, B, native_prefetch=False)
                 for _ in range(3)), _config(tmp_path, JaxConfig))
    params = jax.jit(jflow.data_init)(jparams[1:], jnp.asarray(data[:B]))
    jexp.state = jexp.state._replace(params=params,
                                     opt_state=jexp.tx.init(params))
    jexp._data_initialized = True

    tfull = copy.deepcopy(tfull)
    tflow = Flow(tfull.base_distribution, tfull.layers[1:])
    params_from_jax(tflow, jax.device_get(params))
    texp = Experiment(tflow, *(ArrayLoader(data, B) for _ in range(3)),
                      _config(tmp_path, ExperimentConfig), device="cpu")
    texp._data_initialized = True

    ours, ref = [], []
    for b in range(4):
        x = data[b * B:(b + 1) * B]
        jexp.state, loss, recon = jexp._train_step(
            jexp.state, jnp.asarray(x), jexp._next_rng())
        assert float(recon) == 0.0
        ref.append(float(loss))
        ours.append(float(texp.train_step(torch.from_numpy(x))))
    ours, ref = np.array(ours), np.array(ref)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(ours, ref, rtol=2e-3)
    assert max(p.abs().max().item() for p in tflow.parameters()) <= 0.01
