"""The wide chain blocks and the SLR inverse's early exit, on the CPU.

* The dispatch: every block shape up to RCW = 2048 that the cluster kernel
  refuses goes to the wide cluster kernel, whose shared-memory layout
  (``cluster_wide_layout``, the mirror of ``csrc/chain_solve.cu:wide_plan``)
  fits; its bytes at the two wide shapes this port times: W1, the paper's
  Fig. 4 tall sweep at H = 4160 (``if_tall_timescaling``: 2 x
  ``InvFlowNoPad(1, (2, 2))`` on (B, 1, 4160, 1): RCW = 520, KCW = 1) and
  W2, an ImageNet64 Glow's first level ((B, 12, 32, 32) under a 3x3
  kernel: RCW = KCW = 768).
* W1's model, port (plain chain on the CPU) against the JAX flow the sweep
  builds: log p(x) to rtol 1e-5, gradients to 1e-4 by norm.
* ``slr_inverse_steps`` against a direct loop, and what an early exit
  gives: bit for bit at a fixed point, within the kernel's tolerance
  otherwise; a Newton loop whose derivative is off by 1e-3 (what the
  kernel's approximate division stands in for) lands on the plain loop's
  x.
* ``cuda``-marked card tests of both kernels against their plain versions
  (they skip without a card; the card is decided inside the test). On the
  card: ``python -m pytest --noconftest -m cuda tests/test_torch_wide.py``.
"""

import numpy as np
import pytest
import torch

from inverse_flow_tpu_torch import distributions as td
from inverse_flow_tpu_torch import layers as tl
from inverse_flow_tpu_torch.bridge import params_from_jax
from inverse_flow_tpu_torch.ops import activations as tact
from inverse_flow_tpu_torch.ops import fused_chain as tfc
from inverse_flow_tpu_torch.ops.inv_conv import apply_mask

W1 = (1, 4160, 1)
W2 = (12, 32, 32)


def _norm_rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# The dispatch and the shared-memory mirror
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo", [1, 513, 1025, 1537])
def test_every_shape_the_cluster_kernel_refuses_goes_wide(lo):
    """Every RCW in [lo, lo + 512) and a spread of KCW <= RCW: the
    dispatch picks ``cluster_wide`` wherever the cluster kernel does not
    fit, and the wide kernel's layout fits in 227 KB at one row group."""
    wide = 0
    for rcw in range(lo, lo + 512):
        for kcw in sorted({k for k in (1, 2, 3, 4, rcw // 3, rcw // 2,
                                       rcw - 1, rcw) if 0 < k <= rcw}):
            variant = tfc.chain_variant(rcw, kcw)
            fits = (tfc._cluster_cols(rcw) <= tfc.CLUSTER_MAX_COLS and
                    tfc.cluster_smem_bytes(rcw, kcw) <= tfc.SMEM_LIMIT)
            assert variant == ("cluster" if fits else "cluster_wide")
            layout = tfc.cluster_wide_layout(rcw, kcw)
            assert layout is not None and layout[1] <= tfc.SMEM_LIMIT
            wide += variant == "cluster_wide"
    assert wide > 0


@pytest.mark.parametrize("chw,b,nb,rcw,kcw,kernel", [
    (W1, 128, 8, 520, 1, (2, 2)),
    (W2, 100, 16, 768, 768, (3, 3)),
])
def test_wide_shapes_and_smem(chw, b, nb, rcw, kcw, kernel):
    """The block shape ``chain_inputs`` gives at W1 and W2 (at B = 2; the
    batch does not change it), and the wide kernel's shared memory there:
    W1's slices are resident (36 columns a CTA: 78,336 bytes of slices
    beside 8 x 520 input rows), W2's stream through 3 chunk buffers of 48
    x 272 floats (its slices would take 301,056 bytes a CTA)."""
    c = chw[0]
    x = torch.zeros((2,) + chw)
    w = apply_mask(torch.zeros((c, c) + kernel))
    xb, t_all, g_all, _, k, _ = tfc.chain_inputs(x, (w,), ("TL",))
    assert (xb.shape[0], xb.shape[2], k) == (nb, rcw, kcw)
    assert tfc.chain_variant(rcw, kcw) == "cluster_wide"
    expect = {(520, 1): [(0, 0, 113808), (0, 0, 132880), (0, 0, 151952),
                         (0, 0, 171024)],
              (768, 768): [(3, 256, 225296), (2, 256, 225296),
                           (2, 128, 228368), None]}
    assert [tfc.cluster_wide_layout(rcw, kcw, g) for g in (1, 2, 3, 4)] == \
        expect[(rcw, kcw)]


def test_wide_layout_edges():
    """RCW = KCW = 2048 streams through 2 buffers of 64 rows x 128
    k-columns (two passes of 64 columns a CTA; one 256-column buffer would
    not leave room for a second); RCW = KCW = 512 holds its slices; two
    row groups do not fit at 2048."""
    assert tfc.cluster_wide_layout(2048, 2048) == (2, 128, 229392)
    assert tfc.cluster_wide_layout(2048, 2048, 2) is None
    assert tfc.cluster_wide_layout(512, 512) == (0, 0, 186384)
    assert tfc._wide_cols(2048) == 128 and tfc._wide_cols(520) == 36


# ---------------------------------------------------------------------------
# W1's model against JAX
# ---------------------------------------------------------------------------

def test_tall_sweep_model_matches_jax():
    """``Flow(GaussianPrior, 2 x InvFlowNoPad(1, (2, 2)))`` on (2, 1, 4160,
    1), as ``inverse_flow_tpu/experiments/timescaling.py`` builds it:
    log p(x) (rtol 1e-5) and the gradients of -mean log p(x) (1e-4 by
    norm), port on the plain chain against JAX. (JAX is imported here:
    the card's machine, which runs this file's ``cuda`` tests, has none.)"""
    import jax
    import jax.numpy as jnp

    from inverse_flow_tpu import distributions as jd
    from inverse_flow_tpu import layers as jl
    from inverse_flow_tpu.layers.inv_flow import InvFlowNoPad as JInvFlowNoPad

    jflow = jl.Flow(jd.GaussianPrior(W1), [JInvFlowNoPad(1, (2, 2))
                                           for _ in range(2)])
    jparams, _ = jflow.init(jax.random.PRNGKey(0), W1)
    rs = np.random.RandomState(0)
    jparams = jax.tree_util.tree_map(
        lambda l: np.asarray(l) + 0.05 * rs.randn(*np.shape(l)).astype(
            np.float32), jparams)
    x = rs.randn(2, *W1).astype(np.float32)

    def loss(p):
        lp = jflow.forward(p, jnp.asarray(x))[1]
        return -jnp.mean(lp), lp

    # one compile for both (the exact solve at H = 4160 compiles slowly)
    (_, lp_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jparams)
    lp_j = np.asarray(lp_j)

    tflow = tl.Flow(td.GaussianPrior(W1), [tl.InvFlowNoPad(1, (2, 2))
                                           for _ in range(2)])
    params_from_jax(tflow, jparams)
    seen = []
    record = tfc.chain_phases

    def counted(xb, t_all, g_all, dirs, kcw, pad_cw=0, variant=None):
        seen.append((xb.shape[0], xb.shape[2], kcw))
        return record(xb, t_all, g_all, dirs, kcw, pad_cw, variant)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfc, "chain_phases", counted)
        _, lp_t = tflow(torch.from_numpy(x))
        (-lp_t.mean()).backward()
    # two solves forward and two in the backward, each at W1's block shape
    assert seen == [(8, 520, 1)] * 4
    np.testing.assert_allclose(lp_t.detach().numpy(), lp_j, rtol=1e-5)
    grads = [p.grad.numpy() for p in tflow.parameters()]
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(g_j)]
    assert len(grads) == len(leaves) == 2
    for g, r in zip(grads, leaves):
        assert _norm_rel(g, r.reshape(g.shape)) <= 1e-4


# ---------------------------------------------------------------------------
# The SLR inverse's steps
# ---------------------------------------------------------------------------

def _grid(n=4001):
    return torch.linspace(-40.0, 40.0, n)


def _history(y, alpha):
    """x after each of the reference loop's 100 steps, (100, *y.shape)."""
    x, out = y, []
    for _ in range(tact.NEWTON_ITERS):
        x = tact._newton_step(x, y, alpha)
        out.append(x)
    return torch.stack(out)


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("alpha", [0.3, 0.005])
def test_slr_steps_against_a_direct_loop(alpha):
    """The helper's count against the loop's own history (x_0 = y, x_1,
    ..., x_100, vectorised as the helper runs it: a scalar loop takes
    other rounding paths through exp and log1p): the first step k whose
    x_k equals x_{k-1} bit for bit, else 100; and the loop's x after that
    many steps is its 100-step x, bit for bit, over a grid of y in
    [-40, 40]."""
    y = _grid()
    steps = tact.slr_inverse_steps(y, alpha)
    assert steps.dtype == torch.int32 and steps.min() >= 1
    hist = _history(y, alpha)
    prev = torch.cat([y[None], hist[:-1]])
    same = (_bits(hist) == _bits(prev)).numpy()
    direct = np.where(same.any(0), same.argmax(0) + 1, tact.NEWTON_ITERS)
    np.testing.assert_array_equal(steps.numpy(), direct)
    at = hist.gather(0, (steps.long() - 1)[None])[0]
    assert torch.equal(_bits(at), _bits(hist[-1]))
    assert torch.equal(_bits(hist[-1]),
                       _bits(tact.slr_inverse_reference(y, alpha)))


@pytest.mark.parametrize("alpha", [0.3, 0.005])
def test_slr_exit_tolerance(alpha):
    """The kernel's exit test on the reference loop: the steps it stops
    after are at most the bitwise count, most of y settles within a few
    steps, and the x it stops at is within 2 x SLR_EXIT_TOL x max(1, |x|)
    of the 100-step x (the one bit-for-bit exit is not reached for 15.5%
    of the grid at alpha 0.3: the iterate cycles between floats)."""
    y = _grid()
    steps = tact.slr_inverse_steps(y, alpha, tol=tact.SLR_EXIT_TOL)
    exact = tact.slr_inverse_steps(y, alpha)
    assert (steps <= exact).all()
    assert steps.float().median() <= 12
    hist = _history(y, alpha)
    at = hist.gather(0, (steps.long() - 1)[None])[0]
    dev = (at - hist[-1]).abs() / hist[-1].abs().clamp(min=1.0)
    assert dev.max().item() <= 2 * tact.SLR_EXIT_TOL
    assert (dev == 0).float().mean() > 0.5


@pytest.mark.parametrize("alpha", [0.3, 0.005])
def test_slr_newton_with_a_perturbed_derivative(alpha):
    """Newton with f' off by a relative 1e-3 at every step (seeded, each
    element and step its own) reaches the plain loop's x within
    ``1e-5 * max(1, |y|)`` at alpha 0.3; at alpha 0.005, where x reaches
    200 |y|, within ``1e-5 * max(1, |x|)``."""
    y = _grid()
    gen = torch.Generator().manual_seed(0)
    x = y
    for _ in range(tact.NEWTON_ITERS):
        fprime = torch.clamp(tact.slr_prime(x, alpha), min=tact.FPRIME_FLOOR)
        fprime = fprime * (1 + 1e-3 * (2 * torch.rand(y.shape,
                                                      generator=gen) - 1))
        x = x - (tact.slr(x, alpha) - y) / fprime
    ref = tact.slr_inverse_reference(y, alpha)
    scale = (y if alpha == 0.3 else ref).abs().clamp(min=1.0)
    assert ((x - ref).abs() / scale).max().item() <= 1e-5


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(chw, kernel, n, b, device, seed=0):
    rs = np.random.RandomState(seed)
    c = chw[0]
    x = torch.from_numpy(rs.randn(b, *chw).astype(np.float32)).to(device)
    ws = [apply_mask(torch.from_numpy((0.1 / np.sqrt(c * kernel[0]) * rs.randn(
        c, c, *kernel)).astype(np.float32)).to(device)) for _ in range(n)]
    return x, ws


WIDE_CASES = [(W1, (2, 2), ("TL",), 128), (W2, (3, 3), ("TL",), 100),
              ((32, 8, 8), (3, 3), ("TL", "BR"), 100),
              ((64, 16, 16), (3, 3), ("TL",), 3)]
WIDE_IDS = ["W1", "W2", "512x512", "2048x2048"]


@pytest.mark.cuda
@pytest.mark.parametrize("chw,kernel,orders,b", WIDE_CASES, ids=WIDE_IDS)
def test_wide_kernel_matches_reference(cuda_device, chw, kernel, orders, b):
    """The dispatch's launch on the wide cluster kernel against its plain
    version, forward (1e-5 * max(1, max|y|)) and through
    ``fused_chain_solve``'s backward (dx likewise, dW 1e-4 * max|dW|)."""
    x, ws = _operands(chw, kernel, len(orders), b, cuda_device)
    args = tfc.chain_inputs(x, ws, orders)
    assert tfc.chain_variant(args[0].shape[2], args[4]) == "cluster_wide"
    tfc.reset_launches()
    with torch.no_grad():
        y = tfc.chain_phases(*args)
    torch.cuda.synchronize()
    assert tfc.chain_phases.launches_by_variant["cluster_wide"] == 1
    ref = tfc.chain_phases_reference(*args)
    assert (y - ref).abs().max().item() <= 1e-5 * max(
        1.0, ref.abs().max().item())

    def vjp():
        xv = x.detach().requires_grad_()
        wv = [w.detach().requires_grad_() for w in ws]
        out = tfc.fused_chain_solve(xv, wv, orders)
        gy = torch.ones_like(out)
        return torch.autograd.grad(out, [xv, *wv], gy)

    dx, *dws = vjp()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfc, "chain_phases", tfc.chain_phases_reference)
        ref_dx, *ref_dws = vjp()
    assert (dx - ref_dx).abs().max().item() <= 1e-5 * max(
        1.0, ref_dx.abs().max().item())
    for d, r in zip(dws, ref_dws):
        assert (d - r).abs().max() <= 1e-4 * r.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", tact.SLR_VARIANTS)
@pytest.mark.parametrize("alpha", [0.3, 0.005])
def test_slr_kernels_match_plain_loop(cuda_device, variant, alpha):
    """Both SLR kernels against the plain loop at (100, 12, 16, 16), y in
    [-40, 40]: within 1e-5 * max(1, max|y|) at alpha 0.3 and 1e-5 *
    max|x| at alpha 0.005."""
    y = (80 * torch.rand((100, 12, 16, 16), generator=torch.Generator(
        ).manual_seed(1)) - 40).to(cuda_device)
    tact.reset_slr_launches()
    x = tact.slr_inverse(y, alpha, variant=variant)
    torch.cuda.synchronize()
    assert tact.slr_inverse.launches_by_variant[variant] == 1
    ref = tact.slr_inverse_reference(y, alpha)
    scale = y if alpha == 0.3 else ref
    assert (x - ref).abs().max().item() <= 1e-5 * max(
        1.0, scale.abs().max().item())
