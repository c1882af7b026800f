"""The port's inverse-conv chain against the JAX package, on the CPU.

The same masked kernels and inputs, made with numpy from a seed, go
through JAX ``fused_chain_solve`` (Pallas interpret mode on the CPU), JAX
``inv_conv_solve`` composed per order, and the port's
``fused_chain_solve``, which on a CPU tensor runs the kernel's plain
version. Tolerance: max abs error <= 1e-5 * max(1, max|y|), float32
round-off of a solve whose outputs are of order 1-10. The VJP's weight
gradients, sums over the batch and the image, are held to
1e-4 * max|dW_ref|.

The CUDA kernel itself is tested on the card in ``test_torch_kernel.py``.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_flow_tpu import layers as jl
from inverse_flow_tpu.ops import fused_chain as jfc
from inverse_flow_tpu.ops import inv_conv as jic
from inverse_flow_tpu_torch import layers as tl
from inverse_flow_tpu_torch.bridge import params_from_jax
from inverse_flow_tpu_torch.ops import fused_chain as tfc
from inverse_flow_tpu_torch.ops import inv_conv as tic

from test_torch_kernel import CASES, IDS, _inputs, _tol


def _port_solve(x, ws, orders):
    w_effs = tuple(tic.apply_mask(torch.from_numpy(w)) for w in ws)
    return tfc.fused_chain_solve(torch.from_numpy(x), w_effs, orders).numpy()


@pytest.mark.parametrize("chw,orders", CASES, ids=IDS)
def test_chain_matches_jax_fused(chw, orders):
    x, ws = _inputs(chw, len(orders))
    w_effs = tuple(jic.apply_mask(jnp.asarray(w)) for w in ws)
    ref = np.asarray(jfc.fused_chain_solve(jnp.asarray(x), w_effs, orders))
    before = tfc.chain_phases.launches
    y = _port_solve(x, ws, orders)
    assert tfc.chain_phases.launches == before    # CPU: no kernel launch
    assert np.abs(y - ref).max() <= _tol(ref)


@pytest.mark.parametrize("chw,orders", CASES, ids=IDS)
def test_chain_matches_jax_exact_solve(chw, orders):
    x, ws = _inputs(chw, len(orders), seed=1)
    ref = jfc.chain_solve_reference(
        jnp.asarray(x), tuple(jic.apply_mask(jnp.asarray(w)) for w in ws),
        orders)
    ref = np.asarray(ref)
    y = _port_solve(x, ws, orders)
    assert np.abs(y - ref).max() <= _tol(ref)


@pytest.mark.parametrize("chw", [(4, 14, 14), (8, 7, 7)])
def test_solve_round_trip_and_plain_solve(chw):
    """masked_conv_apply(solve(x)) == x, and the plain row-blocked solve
    (the second reference) agrees with the chain."""
    x, ws = _inputs(chw, 1, seed=2)
    xt = torch.from_numpy(x)
    w_eff = tic.apply_mask(torch.from_numpy(ws[0]))
    y = tfc.fused_chain_solve(xt, (w_eff,), ("TL",))
    back = tic.masked_conv_apply(y, w_eff)
    assert (back - xt).abs().max() <= _tol(x)
    plain = tic.solve_ungrouped(xt, w_eff)
    assert (plain - y).abs().max() <= _tol(y.numpy())


def test_apply_mask_matches_jax_and_rejects_non_square():
    w = np.random.RandomState(3).randn(4, 4, 3, 3).astype(np.float32)
    ours = tic.apply_mask(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jic.apply_mask(w)))
    with pytest.raises(ValueError):
        tic.apply_mask(torch.zeros(4, 2, 3, 3))


def test_block_rows_and_viability_match_jax():
    """The block policy matches JAX's; a height with no split into two
    blocks runs as one block, with the carry width capped at the block's
    (H=1 < KH-1)."""
    for h, cw in [(14, 56), (7, 56), (16, 48), (3, 6), (2, 8)]:
        assert (tfc.choose_block_rows_fused(h, cw, 3)
                == jfc.choose_block_rows_fused(h, cw, 3))
        assert tic._choose_block_rows(h, cw, 3) == jic._choose_block_rows(
            h, cw, 3)
    assert tfc.choose_block_rows_fused(2, 56, 3) is None
    w_eff = tic.apply_mask(torch.zeros(4, 4, 3, 3))
    xb, t_all, g_all, _, kcw, pad_cw = tfc.chain_inputs(
        torch.zeros(1, 4, 1, 14), (w_eff,), ("TL",))
    assert xb.shape == (1, 1, 56) and kcw == 56 and pad_cw == 0
    assert t_all.shape == (1, 56, 56) and g_all.shape == (1, 56, 56)
    x = torch.from_numpy(_inputs((4, 2, 14), 1)[0])
    y = tfc.fused_chain_solve(x, (w_eff,), ("TL",))
    assert torch.equal(y, x)                    # w = 0: T is the identity


def test_chain_phases_reference_pads_and_carries():
    """Every phase output matches JAX's interpret-mode kernel, including
    the re-zeroed tail columns and both carry directions."""
    x, ws = _inputs((8, 7, 7), 2, seed=4)
    orders = ("BL", "TR")
    jw = tuple(jic.apply_mask(jnp.asarray(w)) for w in ws)
    ref = np.asarray(jfc._fused_forward(jnp.asarray(x), jw, orders,
                                        interpret=True))
    tw = tuple(tic.apply_mask(torch.from_numpy(w)) for w in ws)
    ours = tfc.chain_phases(
        *tfc.chain_inputs(torch.from_numpy(x), tw, orders)).numpy()
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= _tol(ref)
    assert not ours[:, -1, :, -5 * 56:].any()       # padded tail rows


# ---------------------------------------------------------------------------
# The backward's solve: the channel-transposed kernel
# ---------------------------------------------------------------------------

def _flip(t, order):
    ax = {"TL": (), "BR": (2, 3)}[order]
    return t.flip(ax) if ax else t


@pytest.mark.parametrize("order", ["TL", "BR"])
@pytest.mark.parametrize("chw", [(4, 14, 14), (8, 7, 7)])
def test_transposed_kernel_solve(chw, order):
    """Solving with the transposed masked kernel (whose within-row matrix
    M0 has upper-triangular diagonal blocks) through the chain and the
    plain solve, against JAX's chain and the round trip through the
    masked conv."""
    g, ws = _inputs(chw, 1, seed=6)
    jw = jnp.transpose(jic.apply_mask(jnp.asarray(ws[0])), (1, 0, 2, 3))
    ref = np.asarray(jfc.fused_chain_solve(jnp.asarray(g), (jw,), (order,)))
    wt = tic.apply_mask(torch.from_numpy(ws[0])).transpose(0, 1)
    gt = torch.from_numpy(g)
    y = tfc.fused_chain_solve(gt, (wt,), (order,))
    plain = _flip(tic.solve_ungrouped(_flip(gt, order), wt), order)
    for out in (y, plain):
        tol = _tol(out.numpy())
        assert np.abs(out.numpy() - ref).max() <= tol
        back = _flip(tic.masked_conv_apply(_flip(out, order),
                                           wt.contiguous()), order)
        assert (back - gt).abs().max() <= tol


@pytest.mark.parametrize("chw", [(8, 2, 2), (4, 4, 4), (2, 1, 5)])
def test_inv_flow_no_pad_small_heights(chw):
    """InvFlowNoPad takes every height the JAX exact solve takes, the ones
    with no split into two row blocks included."""
    jlayer, tlayer = jl.InvFlowNoPad(chw[0], (3, 3)), tl.InvFlowNoPad(
        chw[0], (3, 3))
    jparams, _ = jlayer.init(jax.random.PRNGKey(0), chw)
    jparams = {"w": jparams["w"] + 0.1 * np.random.RandomState(7).randn(
        *jparams["w"].shape).astype(np.float32)}
    params_from_jax(tl.Flow(None, [tlayer]), [jparams])
    x = _inputs(chw, 1, seed=8)[0]
    ref = np.asarray(jax.jit(jlayer.forward)(jparams, jnp.asarray(x))[0])
    with torch.no_grad():
        y, ldj = tlayer(torch.from_numpy(x))
    assert not ldj.any()
    assert np.abs(y.numpy() - ref).max() <= _tol(ref)


# ---------------------------------------------------------------------------
# The VJP, against three oracles
# ---------------------------------------------------------------------------

def _plain_autograd_solve(x, ws, orders):
    """The chain with torch autograd straight through the operator build
    and the plain recurrence: independent of the hand-written backward."""
    w_effs = tuple(tic.apply_mask(w) for w in ws)
    phases = tfc.chain_phases_reference(*tfc.chain_inputs(x, w_effs, orders))
    _, c, h, width = x.shape
    return tfc._from_blocks_trim(phases[-1], c, h, width)


@pytest.mark.parametrize("chw,orders", CASES, ids=IDS)
def test_chain_vjp_matches_jax_and_autograd(chw, orders):
    x, ws = _inputs(chw, len(orders), seed=9)
    gy = np.random.RandomState(10).randn(*x.shape).astype(np.float32)
    jw = tuple(jic.apply_mask(jnp.asarray(w)) for w in ws)

    def jax_vjp(fn):
        _, vjp = jax.vjp(lambda a, w: fn(a, w, orders), jnp.asarray(x), jw)
        dx, dw = vjp(jnp.asarray(gy))
        return np.asarray(dx), [np.asarray(d) for d in dw]

    xt = torch.from_numpy(x).requires_grad_()
    w_effs = [tic.apply_mask(torch.from_numpy(w)).requires_grad_()
              for w in ws]
    before = tfc.chain_phases.launches
    y = tfc.fused_chain_solve(xt, w_effs, orders)
    dx, *dws = torch.autograd.grad(y, [xt, *w_effs], torch.from_numpy(gy))
    assert tfc.chain_phases.launches == before      # CPU: no kernel launch

    def check(ref_dx, ref_dws, ours_dws):
        assert np.abs(dx.numpy() - ref_dx).max() <= _tol(ref_dx)
        for d, r in zip(ours_dws, ref_dws):
            assert np.abs(d - r).max() <= 1e-4 * np.abs(r).max()

    dws = [d.numpy() for d in dws]
    check(*jax_vjp(jfc.fused_chain_solve), dws)
    check(*jax_vjp(jfc.chain_solve_reference), dws)

    # plain autograd, in the raw weights: the mask zeroes the entries
    # whose derivative the truncated Newton-Schulz series does not carry
    raw = [torch.from_numpy(w).requires_grad_() for w in ws]
    xr = torch.from_numpy(x).requires_grad_()
    y_ref = _plain_autograd_solve(xr, raw, orders)
    ref_dx, *ref_dws = torch.autograd.grad(y_ref, [xr, *raw],
                                           torch.from_numpy(gy))
    w_raw = [torch.from_numpy(w).requires_grad_() for w in ws]
    ours = torch.autograd.grad(
        tfc.fused_chain_solve(xt, [tic.apply_mask(w) for w in w_raw],
                              orders), w_raw, torch.from_numpy(gy))
    check(ref_dx.numpy(), [d.numpy() for d in ref_dws],
          [d.numpy() for d in ours])


def _port_modules():
    import inverse_flow_tpu_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        inverse_flow_tpu_torch.__path__, "inverse_flow_tpu_torch."))


def test_port_imports_no_jax():
    """Every module of the port imports, and neither jax nor the JAX
    package comes with it."""
    mods = _port_modules()
    assert {f"inverse_flow_tpu_torch.train.{m}" for m in (
        "config", "experiment", "memory", "metrics", "optim", "stats")} \
        <= set(mods)
    assert {"inverse_flow_tpu_torch.layers.padded_conv",
            "inverse_flow_tpu_torch.utils.imaging"} <= set(mods)
    assert {f"inverse_flow_tpu_torch.{m}" for m in (
        "bench", "cli", "data.digits", "data.patches",
        "experiments.real_data",
        "experiments.registry", "ops.activations", "train.checkpoint",
        "utils.profiling", "parallel", "parallel.data_parallel",
        "parallel.mesh", "native",
        "data.toy", "data.galaxy")} <= set(mods)
    assert {f"inverse_flow_tpu_torch.{m}" for m in (
        "layers.convexp", "layers.gaussianize", "layers.splines",
        "layers.activations", "models.fastflow", "distributions")} \
        <= set(mods)
    assert {"inverse_flow_tpu_torch.data.cifar10",
            "inverse_flow_tpu_torch.experiments.bench_configs"} <= set(mods)
    code = (f"import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"sys.exit(sorted(n for n in sys.modules if n == 'jax' or "
            f"n.split('.')[0] == 'inverse_flow_tpu') or 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True)
    assert run.returncode == 0, run.stderr


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py imports nothing of jax or the JAX package; all it
    imports from the repo is the port."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    tops = {n.split(".")[0] for n in names}
    assert "inverse_flow_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "inverse_flow_tpu"}, names
