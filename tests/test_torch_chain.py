"""The port's inverse-conv chain against the JAX package, on the CPU.

The same masked kernels and inputs, made with numpy from a seed, go
through JAX ``fused_chain_solve`` (Pallas interpret mode on the CPU), JAX
``inv_conv_solve`` composed per order, and the port's
``fused_chain_solve``, which on a CPU tensor runs the kernel's plain
version. Tolerance: max abs error <= 1e-5 * max(1, max|y|), float32
round-off of a solve whose outputs are of order 1-10.

The CUDA kernel itself is tested on the card in ``test_torch_kernel.py``.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_flow_tpu.ops import fused_chain as jfc
from inverse_flow_tpu.ops import inv_conv as jic
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
    for h, cw in [(14, 56), (7, 56), (16, 48), (3, 6), (2, 8)]:
        assert (tfc.choose_block_rows_fused(h, cw, 3)
                == jfc.choose_block_rows_fused(h, cw, 3))
        assert tic._choose_block_rows(h, cw, 3) == jic._choose_block_rows(
            h, cw, 3)
    assert tfc.choose_block_rows_fused(2, 56, 3) is None
    with pytest.raises(NotImplementedError):
        tfc.fused_chain_solve(torch.zeros(1, 4, 2, 14),
                              (tic.apply_mask(torch.zeros(4, 4, 3, 3)),),
                              ("TL",))


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


def _port_modules():
    import inverse_flow_tpu_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        inverse_flow_tpu_torch.__path__, "inverse_flow_tpu_torch."))


def test_port_imports_no_jax():
    """Every module of the port imports, and neither jax nor the JAX
    package comes with it."""
    mods = _port_modules()
    assert "inverse_flow_tpu_torch.train.experiment" in mods
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
