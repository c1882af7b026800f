"""The ImageNet32 slice (InvFlowUnit, SmoothLeakyRelu, the order-batched
operator build and the ``imagenet32`` model) against the JAX package, on
the CPU.

Inputs come from numpy with a seed; weights cross with ``params_from_jax``.
On a CPU tensor the port's chain runs its plain version; the JAX unit runs
its fused Pallas path in interpret mode and its default ``'auto'`` path
(the batched exact chain).

Tolerances: y within 1e-5 * max(1, max|y|) and dx likewise (float32
round-off of four chained solves with outputs of order 1-10); each dW
within 1e-4 * max|dW| (sums over batch and image); SmoothLeakyRelu rtol
1e-6 (elementwise); the batched build against four single builds 1e-6
(the same products in another batching); the reduced model's log p(x)
rtol 1e-5 and its Adam losses rel 2e-3, as ``test_torch_glow.py`` and
``test_torch_train.py``.
"""

import copy
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_flow_tpu import layers as jl
from inverse_flow_tpu.data.loader import ArrayLoader as JaxLoader
from inverse_flow_tpu.layers import Flow as JaxFlow
from inverse_flow_tpu.models.glow import build_glow as jax_build_glow
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

from test_torch_kernel import _inputs, _tol

ORDERS = ("TL", "TR", "BL", "BR")
# the reduced imagenet32 model: (3, 8, 8) data, L=2 x K=2, width 16, SLR;
# its solves run at (12, 4, 4) (two row blocks) and (24, 2, 2) (one)
MODEL_KW = dict(step_kind="inv_flow_unit", num_blocks=2, block_size=2,
                coupling_width=16, activation="SLR")
SIZE = (3, 8, 8)
B = 8


def _unit_pair(chw, solver):
    """The JAX unit and the port's, with the same weights (JAX's init
    plus 0.1 / sqrt(C) * randn, so that the solves are far from the
    identity and max|y| stays near 5, as in ``test_torch_kernel._inputs``)."""
    c = chw[0]
    jlayer = jl.InvFlowUnit(c, (3, 3), solver=solver)
    jparams, _ = jlayer.init(jax.random.PRNGKey(0), chw)
    rs = np.random.RandomState(1)
    jparams = {"convs": [{"w": p["w"] + (0.1 / np.sqrt(c) * rs.randn(
        *p["w"].shape)).astype(np.float32)} for p in jparams["convs"]]}
    tlayer = tl.InvFlowUnit(c, (3, 3), solver=solver)
    params_from_jax(Flow(None, [tlayer]), [jparams])
    return jlayer, jparams, tlayer


@pytest.mark.parametrize("solver", ["fused", "auto"])
@pytest.mark.parametrize("chw", [(12, 16, 16), (48, 4, 4)],
                         ids=["12x16x16", "48x4x4"])
def test_inv_flow_unit_matches_jax(chw, solver):
    """y, ldj, dx and the four dW of the unit against the JAX unit's
    forward and ``jax.grad``; no kernel launch on the CPU."""
    jlayer, jparams, tlayer = _unit_pair(chw, solver)
    x = _inputs(chw, 0, b=2, seed=2)[0]
    r = np.random.RandomState(3).randn(*x.shape).astype(np.float32)

    def scalar(p, a):
        return jnp.sum(jlayer.forward(p, a)[0] * r)

    y_ref, ldj_ref = jax.jit(jlayer.forward)(jparams, jnp.asarray(x))
    gp, gx = jax.jit(jax.grad(scalar, argnums=(0, 1)))(jparams,
                                                       jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    before = tfc.chain_phases.launches
    y, ldj = tlayer(xt)
    (y * torch.from_numpy(r)).sum().backward()
    assert tfc.chain_phases.launches == before
    assert not ldj.any() and not np.asarray(ldj_ref).any()
    y_ref = np.asarray(y_ref)
    assert np.abs(y.detach().numpy() - y_ref).max() <= _tol(y_ref)
    gx = np.asarray(gx)
    assert np.abs(xt.grad.numpy() - gx).max() <= _tol(gx)
    for i in range(4):
        ours = tlayer.get_parameter(f"convs.{i}.w").grad.numpy()
        ref = np.asarray(gp["convs"][i]["w"])
        assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max(), i


def test_inv_flow_unit_solvers_and_names():
    """'auto' (outside the Jacobi window), 'exact' and 'fused' are one
    function; 'jacobi' solves order by order through its four 'jacobi'
    child convs; the parameters carry the JAX names."""
    x = torch.from_numpy(_inputs((12, 4, 4), 0, b=2, seed=4)[0])
    gen = torch.Generator().manual_seed(0)
    units = [tl.InvFlowUnit(12, solver=s) for s in ("auto", "exact",
                                                      "fused")]
    w = {n: 0.1 * torch.randn(p.shape, generator=gen)
         for n, p in units[0].named_parameters()}
    assert sorted(w) == [f"convs.{i}.w" for i in range(4)]
    ys = [u.forward_with(w, x)[0] for u in units]
    for y in ys[1:]:
        assert torch.equal(y, ys[0])
    jacobi = tl.InvFlowUnit(12, solver="jacobi")
    assert [c.solver for c in jacobi.convs] == ["jacobi"] * 4
    y = x
    for i, conv in enumerate(jacobi.convs):
        y = conv.forward_with({"w": w[f"convs.{i}.w"]}, y)[0]
    assert torch.equal(jacobi.forward_with(w, x)[0], y)
    with pytest.raises(ValueError):
        tl.InvFlowUnit(12, solver="newton")


def test_smooth_leaky_relu_matches_jax():
    """Forward and ldj, at |x| up to 100 (beyond ``F.softplus``'s
    threshold of 20), and the gradient. atol 1e-7 on y covers its zero
    crossing near x = -1.1, where the two packages' exp and log1p differ
    by an ulp of the summands (seen: 3e-8)."""
    rs = np.random.RandomState(5)
    x = (5.0 * rs.randn(4, 3, 5, 5)).astype(np.float32)
    x.reshape(-1)[:8] = [30.0, -30.0, 50.0, -50.0, 100.0, -100.0, 20.5,
                         -20.5]
    jlayer, tlayer = jl.SmoothLeakyRelu(), tl.SmoothLeakyRelu()
    y_ref, ldj_ref = jlayer.forward({}, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, ldj = tlayer(xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ldj.detach().numpy(), np.asarray(ldj_ref),
                               rtol=1e-6)
    gx = jax.grad(lambda a: jnp.sum(jlayer.forward({}, a)[0])
                  + jnp.sum(jlayer.forward({}, a)[1]))(jnp.asarray(x))
    (y.sum() + ldj.sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-6,
                               atol=1e-7)
    assert not list(tlayer.parameters())


@pytest.mark.parametrize("chw,r", [((12, 16, 16), 2), ((4, 14, 14), 7)])
def test_batched_build_matches_single_builds(chw, r):
    """One build over four stacked kernels against four builds of one,
    and the chain's permuted operators against per-order ones."""
    c, _, width = chw
    ws = torch.stack([tic.apply_mask(torch.from_numpy(w))
                      for w in _inputs(chw, 4, seed=6)[1]])
    mats = tic._row_matrices(ws, width)
    t_inv = tic._block_toeplitz_inverse(mats, r)
    prev = tic._prev_block(mats, r)
    for i in range(4):
        one = tic._row_matrices(ws[i:i + 1], width)
        torch.testing.assert_close(mats[i:i + 1], one, rtol=0, atol=0)
        torch.testing.assert_close(
            t_inv[i:i + 1], tic._block_toeplitz_inverse(one, r), rtol=0,
            atol=1e-6)
        torch.testing.assert_close(prev[i:i + 1], tic._prev_block(one, r),
                                   rtol=0, atol=0)
    kcw = 2 * c * width
    t_all, g_all = tfc._phase_matrices(tuple(ws), ORDERS, width, r, kcw)
    for i, o in enumerate(ORDERS):
        t1, g1 = tfc._phase_matrices((ws[i],), (o,), width, r, kcw)
        torch.testing.assert_close(t_all[i:i + 1], t1, rtol=0, atol=1e-6)
        torch.testing.assert_close(g_all[i:i + 1], g1, rtol=0, atol=1e-6)
    # the JAX package's unbatched build gives the same operator
    ref = jic._block_toeplitz_inverse(
        jic._row_matrices(jnp.asarray(ws[0].numpy()), width), r,
        width=width)
    np.testing.assert_allclose(t_inv[0].numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("chw,orders", [((4, 6, 6), ("TL",)),
                                        ((12, 4, 4), ORDERS)],
                         ids=["TL", "unit"])
def test_dense_operator_and_library_yardstick(chw, orders):
    """``dense_operator`` is JAX's; the triangular solves that chip_smoke
    times as the library call compute the chain (forward) and its
    cotangent map (backward)."""
    x, ws = _inputs(chw, len(orders), b=3, seed=7)
    w_effs = [tic.apply_mask(torch.from_numpy(w)) for w in ws]
    dense = tic.dense_operator(w_effs[0], *chw)
    ref = jic.dense_operator(jnp.asarray(w_effs[0].numpy()), *chw)
    np.testing.assert_allclose(dense.numpy(), np.asarray(ref), atol=1e-7)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(
        (dense @ xt.reshape(3, -1).T).T.reshape(xt.shape).numpy(),
        tic.masked_conv_apply(xt, w_effs[0]).numpy(), atol=1e-5)

    smoke = _chip_smoke()
    wr = [w.clone().requires_grad_() for w in w_effs]
    xr = xt.clone().requires_grad_()
    y = tfc.fused_chain_solve(xr, wr, orders)
    g = torch.from_numpy(np.random.RandomState(8).randn(*x.shape).astype(
        np.float32))
    dx = torch.autograd.grad(y, xr, g)[0]
    for backward, arg, want in ((False, xt, y), (True, g, dx)):
        fn = smoke.library_chain(arg, w_effs, orders, backward, torch)
        got = smoke.from_columns(fn(), arg.shape)
        assert (got - want).abs().max() <= _tol(want.detach().numpy())


@pytest.mark.parametrize("chw,orders", [((8, 7, 7), ("BR",)),
                                        ((12, 4, 4), ORDERS)],
                         ids=["padded-BR", "unit"])
def test_chain_bound_counts_the_products_the_data_needs(chw, orders):
    """chip_smoke's bound counts one multiply-add per nonzero product of
    the recurrence, as counted here on a run of the plain version: T is a
    permuted unit triangle whose diagonal is a copy, and a padded tail
    column (zero in every phase) takes part in no product. That is well
    under the dense count ``NB * RCW^2 + (NB-1) * RCW * KCW`` per order."""
    smoke = _chip_smoke()
    x, ws = _inputs(chw, len(orders), b=1, seed=9)
    args = tfc.chain_inputs(
        torch.from_numpy(x),
        [tic.apply_mask(torch.from_numpy(w)) for w in ws], orders)
    xb, t_all, g_all, dirs, kcw, pad_cw = args
    nb, _, rcw = xb.shape
    assert (torch.diagonal(t_all, dim1=1, dim2=2) == 1).all()
    assert ((t_all != 0).sum((1, 2)) - rcw <= rcw * (rcw - 1) // 2).all()

    phases = tfc.chain_phases_reference(*args)
    t_off = ((t_all != 0) & ~torch.eye(rcw, dtype=torch.bool)).float()
    g_nz = (g_all != 0).float()
    count = 0.0
    for o, flip_h in enumerate(dirs):
        src = xb if o == 0 else phases[o - 1]
        carry = None
        for i in range(nb):
            m = nb - 1 - i if flip_h else i
            out = phases[o, m, 0] != 0
            per_col = t_off[o] @ (src[m, 0] != 0).float()
            if carry is not None:
                per_col = per_col + g_nz[o] @ (carry != 0).float()
            count += per_col[out].sum().item()
            y = phases[o, m, 0]
            carry = y[:kcw] if flip_h else y[rcw - kcw:]
    bound_ms, _, fma = smoke.chain_bound(args, torch)
    assert fma == count and bound_ms > 0
    assert fma < len(dirs) * (nb * rcw ** 2 + (nb - 1) * rcw * kcw) * 0.75


@pytest.mark.parametrize("chw,orders", [((8, 7, 7), ("BR",)),
                                        ((12, 4, 4), ORDERS)],
                         ids=["padded-BR", "unit"])
def test_chain_work_bytes_count_the_live_entries(chw, orders):
    """``chain_work``'s bytes are those a run of the plain version reads
    and writes that carry data: x's entries and every phase output's
    (random inputs, so nonzero but in the padded tail columns, which no
    product reads or writes), T's entries but a unit diagonal and G's
    nonzero entries, 4 bytes each. At (8, 7, 7) the padded tail is 280 of
    336 x 2 columns, which a count over the whole blocks would charge."""
    x, ws = _inputs(chw, len(orders), b=2, seed=9)
    args = tfc.chain_inputs(
        torch.from_numpy(x),
        [tic.apply_mask(torch.from_numpy(w)) for w in ws], orders)
    xb, t_all, g_all, dirs, kcw, pad_cw = args
    rcw = xb.shape[2]
    phases = tfc.chain_phases_reference(*args)
    t_live = (t_all != 0) & ~(torch.eye(rcw, dtype=torch.bool)
                              & (t_all == 1))
    live = int((xb != 0).sum() + (phases != 0).sum() + t_live.sum()
               + (g_all != 0).sum())
    assert tfc.chain_work(args)[1] == 4 * live
    if chw == (8, 7, 7):
        # x and the one phase output, 2 rows each, less their tails
        assert pad_cw == 280 and (xb[-1, :, rcw - pad_cw:] == 0).all()
        whole = 4 * (live + (1 + len(dirs)) * xb.shape[1] * pad_cw)
        assert whole - tfc.chain_work(args)[1] == 4 * 2 * 2 * 280


def test_build_glow_step_kinds_and_refusals():
    """The unit step kinds build the JAX parameter names; ``convexp`` and
    ``SplineNat`` build; ``coupling_dtype`` reaches every coupling net
    (the JAX spellings of bf16), and an unknown one raises."""
    for kind in ("inv_flow_unit", "inv_flow_unit_exact",
                 "inv_flow_unit_fused", "inv_flow_unit_jacobi"):
        flow = build_glow(SIZE, **dict(MODEL_KW, step_kind=kind),
                          device="cpu")
        shape = flow.layers[5].get_parameter("steps.1.convs.3.w").shape
        assert shape == (2, 12, 12, 3, 3)
        assert isinstance(flow.layers[5].steps[2], tl.SmoothLeakyRelu)
    flow = build_glow(SIZE, **dict(MODEL_KW, step_kind="convexp",
                                   activation="SplineNat"), device="cpu")
    assert isinstance(flow.layers[5].steps[1], tl.ConvExp)
    assert isinstance(flow.layers[5].steps[2], tl.SplineActivation)
    for name in ("bfloat16", "bf16"):
        flow = build_glow(SIZE, **dict(MODEL_KW, coupling_dtype=name),
                          device="cpu")
        nets = [m for m in flow.modules() if isinstance(m, tl.Coupling)]
        assert len(nets) == 3                  # two blocks' and a SplitPrior
        assert all(m.compute_dtype == torch.bfloat16 for m in nets)
    with pytest.raises(ValueError, match="float16"):
        build_glow(SIZE, **dict(MODEL_KW, coupling_dtype="float16"),
                   device="cpu")


# ---------------------------------------------------------------------------
# The reduced imagenet32 model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jflow = jax_build_glow(SIZE, **MODEL_KW)
    jparams = jax.device_get(jax.jit(
        lambda key: jflow.init(key, SIZE)[0])(jax.random.PRNGKey(0)))
    tflow = build_glow(SIZE, **MODEL_KW, device="cpu")
    params_from_jax(tflow, jparams)
    rs = np.random.RandomState(9)
    data = (rs.randint(0, 256, (4 * B,) + SIZE)
            + rs.uniform(0.0, 1.0, (4 * B,) + SIZE)).astype(np.float32)
    return jflow, jparams, tflow, data


def test_params_round_trip_through_jax_tree(model):
    _, jparams, tflow, _ = model
    back = params_to_jax(tflow)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jparams))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_reduced_model_logpx_matches_jax(model):
    """Data init, then log p(x) after dequantization on the same x + u."""
    jflow, jparams, tflow, data = model
    x = data[:B]
    jsub = JaxFlow(jflow.base_distribution, jflow.layers[1:])
    jnew = jax.jit(jsub.data_init)(jparams[1:], jnp.asarray(x))
    zj, lpj = jax.jit(jsub.forward)(jnew, jnp.asarray(x))
    tflow = copy.deepcopy(tflow)
    tsub = Flow(tflow.base_distribution, tflow.layers[1:])
    tsub.data_init(torch.from_numpy(x))
    with torch.no_grad():
        zt, lpt = tsub(torch.from_numpy(x))
    assert zt.shape == (B, 24, 2, 2)
    assert np.isfinite(lpt.numpy()).all()
    np.testing.assert_allclose(lpt.numpy(), np.asarray(lpj), rtol=1e-5)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-4,
                               rtol=0)


def _config(tmp_path, cls):
    """The ``imagenet32`` training config (Adam, no warmup, no scheduler,
    no clamp), at lr 1e-3 so that a few steps move the loss."""
    return cls(name="imagenet32", lr=1e-3, batch_size=B, warmup_epochs=0,
               scheduler_name="None", weight_clamp=None,
               add_recon_grad=False, log_timing=False, save_images=False,
               plot_recon=False, metrics_path=str(tmp_path / "m.jsonl"),
               checkpoint_path=str(tmp_path / "c.pkl"), seed=0)


def test_reduced_model_adam_steps_match_jax(tmp_path, model):
    """JAX's data init, then 4 Adam steps through JAX's
    ``Experiment._train_step`` and the port's ``train_step`` from the same
    weights, on pre-dequantized batches."""
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
        jexp.state, loss, _ = jexp._train_step(jexp.state, jnp.asarray(x),
                                               jexp._next_rng())
        ref.append(float(loss))
        ours.append(float(texp.train_step(torch.from_numpy(x))))
    ours, ref = np.array(ours), np.array(ref)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(ours, ref, rtol=2e-3)
