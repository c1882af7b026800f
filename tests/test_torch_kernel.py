"""The chain kernel's, the SLR-inverse and the SmoothTanh-inverse kernels'
wrappers, the CUDA kernels on the card, and the layer zoo's reduced
FastFlow and exponential_cnn_mnist steps on the card.

This file imports no JAX, so the card's tests run where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel.py

(``--noconftest``: the suite's conftest.py sets JAX up). Without a card the
``cuda`` tests skip. Each kernel case runs on every CUDA kernel
(``variant``: the cluster kernel that every model shape dispatches to, and
the wide cluster kernel and the streaming kernel forced); one wide case
reaches the wide cluster kernel through the dispatch. Tolerance: max abs error <= 1e-5 * max(1, max|y|),
float32 round-off of a solve whose outputs are of order 1-10; weight
gradients (sums over batch and image) to 1e-4 * max|dW_ref|.
"""

import copy
from unittest import mock

import numpy as np
import pytest
import torch

from inverse_flow_tpu_torch.layers import Flow
from inverse_flow_tpu_torch.models.glow import build_glow
from inverse_flow_tpu_torch.ops import activations as tact
from inverse_flow_tpu_torch.ops import fused_chain as tfc
from inverse_flow_tpu_torch.ops.inv_conv import apply_mask

# the shapes and orders of chip_smoke.py's kernel phase: both flagship
# solve shapes, the padded tail of (8, 7, 7), both scan directions, and a
# four-order chain
CASES = [
    ((4, 14, 14), ("TL",)),
    ((8, 7, 7), ("TL",)),
    ((8, 7, 7), ("BR",)),
    ((4, 14, 14), ("TL", "TR", "BL", "BR")),
]
IDS = ["4x14x14-TL", "8x7x7-TL", "8x7x7-BR", "4x14x14-unit"]
# the imagenet32 model's InvFlowUnit solve shapes (levels 1-3): N=4,
# R=2, NB=8/4/2, RCW=KCW=384
UNIT_SHAPES = [(12, 16, 16), (24, 8, 8), (48, 4, 4)]
UNIT_IDS = ["12x16x16", "24x8x8", "48x4x4"]
UNIT = ("TL", "TR", "BL", "BR")
# ff_glow_mnist's FincFlowUnit inverse: the groups-4 kernel expanded to a
# dense block-diagonal one, one TL order, at the flagship's shapes
FF_SHAPES = [(4, 14, 14), (8, 7, 7)]
FF_IDS = ["4x14x14", "8x7x7"]
VARIANTS = ["cluster", "cluster_wide", "streaming"]


def _inputs(chw, n, b=3, seed=0):
    """Inputs and ``n`` kernels of std 0.1 / sqrt(C), as chip_smoke.py
    draws them: max|y| near 5 at every case (a std of 0.1 drives the
    four-order chains at C >= 12 to |y| of 1e3-1e4)."""
    rs = np.random.RandomState(seed)
    c = chw[0]
    x = rs.randn(b, *chw).astype(np.float32)
    ws = [(0.1 / np.sqrt(c) * rs.randn(c, c, 3, 3)).astype(np.float32)
          for _ in range(n)]
    return x, ws


def _tol(y):
    return 1e-5 * max(1.0, float(np.abs(y).max()))


def _forced(variant):
    """A context in which the dispatch sends every solve to ``variant``."""
    return mock.patch.object(tfc, "chain_variant", lambda rcw, kcw: variant)


def _launched(variant, n, before):
    """``chain_phases`` counted ``n`` more launches, all of ``variant``,
    since ``before`` = (total, by variant)."""
    total, by = before
    assert tfc.chain_phases.launches == total + n
    assert tfc.chain_phases.launches_by_variant == dict(
        by, **{variant: by[variant] + n})


def _counts():
    return (tfc.chain_phases.launches,
            dict(tfc.chain_phases.launches_by_variant))


def _args(chw, orders, b, device, seed=5):
    x, ws = _inputs(chw, len(orders), b=b, seed=seed)
    w_effs = tuple(apply_mask(torch.from_numpy(w).to(device)) for w in ws)
    return tfc.chain_inputs(torch.from_numpy(x).to(device), w_effs, orders)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_chain_phases_cpu_is_the_plain_version():
    args = _args((8, 7, 7), ("BR",), 2, "cpu")
    before = tfc.chain_phases.launches
    y = tfc.chain_phases(*args)
    assert tfc.chain_phases.launches == before
    assert torch.equal(y, tfc.chain_phases_reference(*args))


def test_chain_phases_rejects_other_devices():
    args = _args((4, 14, 14), ("TL",), 2, "cpu")
    meta = tuple(a.to("meta") if torch.is_tensor(a) else a for a in args)
    with pytest.raises(ValueError):
        tfc.chain_phases(*meta)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("b", [100, 1])
@pytest.mark.parametrize("chw,orders", CASES, ids=IDS)
def test_kernel_matches_reference(cuda_device, chw, orders, b, variant):
    """The CUDA kernel against its plain version, on the card, at B=100
    and B=1; the dispatch sends every case to the cluster kernel."""
    args = _args(chw, orders, b, cuda_device)
    assert tfc.chain_variant(args[0].shape[2], args[4]) == "cluster"
    before = _counts()
    with torch.no_grad():
        y = tfc.chain_phases(*args, variant=variant)
    torch.cuda.synchronize()
    _launched(variant, 1, before)
    ref = tfc.chain_phases_reference(*args)
    assert (y - ref).abs().max().item() <= _tol(ref.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_ragged_batch_and_checks(cuda_device, variant):
    """A batch that is not a multiple of the kernel's batch tile, and the
    wrapper's refusals: grad, dtype, layout."""
    args = _args((8, 7, 7), ("TL", "BL"), 7, cuda_device)
    y = tfc.chain_phases(*args, variant=variant)
    ref = tfc.chain_phases_reference(*args)
    assert (y - ref).abs().max().item() <= _tol(ref.cpu().numpy())
    xb, t_all, g_all, dirs, kcw, pad_cw = args
    with pytest.raises(NotImplementedError):
        tfc.chain_phases(xb.clone().requires_grad_(), t_all, g_all, dirs,
                         kcw, pad_cw)
    with pytest.raises(TypeError):
        tfc.chain_phases(xb.double(), t_all, g_all, dirs, kcw, pad_cw)
    with pytest.raises(ValueError):
        tfc.chain_phases(xb.transpose(0, 1), t_all, g_all, dirs, kcw,
                         pad_cw)


def _vjp(chw, orders, device, b=100):
    """dx and every dW of ``fused_chain_solve`` under a random cotangent."""
    x, ws = _inputs(chw, len(orders), b=b, seed=11)
    gy = np.random.RandomState(12).randn(*x.shape).astype(np.float32)
    xt = torch.from_numpy(x).to(device).requires_grad_()
    w_effs = [apply_mask(torch.from_numpy(w).to(device)).requires_grad_()
              for w in ws]
    y = tfc.fused_chain_solve(xt, w_effs, orders)
    return torch.autograd.grad(y, [xt, *w_effs],
                               torch.from_numpy(gy).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("chw,orders", CASES, ids=IDS)
def test_backward_kernel_matches_reference(cuda_device, chw, orders,
                                           variant):
    """The backward through the kernel (two launches: forward and the
    backward's solve) against the same autograd Function on the plain
    recurrence, on the card, at B=100."""
    before = _counts()
    with _forced(variant):
        dx, *dws = _vjp(chw, orders, cuda_device)
    torch.cuda.synchronize()
    _launched(variant, 2, before)
    with mock.patch.object(tfc, "chain_phases", tfc.chain_phases_reference):
        ref_dx, *ref_dws = _vjp(chw, orders, cuda_device)
    assert (dx - ref_dx).abs().max().item() <= _tol(ref_dx.cpu().numpy())
    for d, r in zip(dws, ref_dws):
        assert (d - r).abs().max() <= 1e-4 * r.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("chw", [(8, 2, 2), (2, 1, 5)])
def test_kernel_single_block(cuda_device, chw, variant):
    """Heights with no split into two row blocks run as one block (the
    carry width capped at the block's when H < KH-1), forward and
    backward, on the card. (2, 1, 5) has RCW = 10, not a multiple of 4:
    the cluster kernel's element-wise copies instead of its bulk ones."""
    args = _args(chw, ("TL", "BR"), 9, cuda_device)
    assert args[0].shape[0] == 1
    y = tfc.chain_phases(*args, variant=variant)
    ref = tfc.chain_phases_reference(*args)
    assert (y - ref).abs().max().item() <= _tol(ref.cpu().numpy())
    with _forced(variant):
        dx, *dws = _vjp(chw, ("BR",), cuda_device, b=9)
    with mock.patch.object(tfc, "chain_phases", tfc.chain_phases_reference):
        ref_dx, *ref_dws = _vjp(chw, ("BR",), cuda_device, b=9)
    assert (dx - ref_dx).abs().max().item() <= _tol(ref_dx.cpu().numpy())
    for d, r in zip(dws, ref_dws):
        assert (d - r).abs().max() <= 1e-4 * r.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("b", [100, 1])
@pytest.mark.parametrize("chw", UNIT_SHAPES, ids=UNIT_IDS)
def test_unit_kernel_matches_reference(cuda_device, chw, b, variant):
    """The four-order chain at the imagenet32 shapes, B=100 and B=1, on
    the card: the forward launch, and the backward (its launch on the
    complementary orders with transposed kernels, and the four dW)
    against the same Function on the plain recurrence."""
    args = _args(chw, UNIT, b, cuda_device)
    assert args[0].shape[0] == chw[1] // 2             # NB, R=2
    assert args[2].shape == (4, 384, 384)              # KCW = RCW
    with torch.no_grad():
        y = tfc.chain_phases(*args, variant=variant)
    ref = tfc.chain_phases_reference(*args)
    assert ref.abs().max().item() < 20      # the limit stays near 1e-4
    assert (y - ref).abs().max().item() <= _tol(ref.cpu().numpy())
    before = _counts()
    with _forced(variant):
        dx, *dws = _vjp(chw, UNIT, cuda_device, b=b)
    torch.cuda.synchronize()
    _launched(variant, 2, before)
    with mock.patch.object(tfc, "chain_phases", tfc.chain_phases_reference):
        ref_dx, *ref_dws = _vjp(chw, UNIT, cuda_device, b=b)
    assert (dx - ref_dx).abs().max().item() <= _tol(ref_dx.cpu().numpy())
    for d, r in zip(dws, ref_dws):
        assert (d - r).abs().max() <= 1e-4 * r.abs().max()


def _grouped_args(chw, b, device, seed=13):
    """The chain's arguments for a FincFlowUnit inverse: four chunk
    kernels of the model's init scale (normal(0, 0.05)), masked, expanded
    into one dense kernel."""
    rs = np.random.RandomState(seed)
    c = chw[0]
    x = rs.randn(b, *chw).astype(np.float32)
    w_eff = torch.cat([apply_mask(torch.from_numpy(
        (0.05 * rs.randn(c // 4, c // 4, 3, 3)).astype(np.float32)))
        for _ in range(4)])
    w = tfc.expand_grouped_kernel(w_eff, 4).to(device)
    return tfc.chain_inputs(torch.from_numpy(x).to(device), (w,), ("TL",))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("b", [100, 1])
@pytest.mark.parametrize("chw", FF_SHAPES, ids=FF_IDS)
def test_grouped_kernel_matches_reference(cuda_device, chw, b, variant):
    """The expanded groups-4 kernel through the CUDA kernel against its
    plain version, at the sample batch (100) and at one image."""
    args = _grouped_args(chw, b, cuda_device)
    before = _counts()
    with torch.no_grad():
        y = tfc.chain_phases(*args, variant=variant)
    torch.cuda.synchronize()
    _launched(variant, 1, before)
    ref = tfc.chain_phases_reference(*args)
    assert (y - ref).abs().max().item() <= _tol(ref.cpu().numpy())


@pytest.mark.cuda
def test_wide_block_dispatches_to_the_streaming_kernel(cuda_device):
    """(32, 8, 8) solves in blocks of RCW = KCW = 512, whose slices do not
    fit the cluster kernel's shared memory: the dispatch launches the wide
    cluster kernel (which took such shapes over from the streaming
    kernel), which agrees with the plain version, forward and backward; a
    forced cluster launch is refused and raises."""
    args = _args((32, 8, 8), ("TL", "BR"), 7, cuda_device)
    assert args[0].shape[2] == args[4] == 512
    assert tfc.chain_variant(512, 512) == "cluster_wide"
    before = _counts()
    y = tfc.chain_phases(*args)
    torch.cuda.synchronize()
    _launched("cluster_wide", 1, before)
    ref = tfc.chain_phases_reference(*args)
    assert (y - ref).abs().max().item() <= _tol(ref.cpu().numpy())
    with pytest.raises(RuntimeError):
        tfc.chain_phases(*args, variant="cluster")
    dx, *dws = _vjp((32, 8, 8), ("TL",), cuda_device, b=7)
    with mock.patch.object(tfc, "chain_phases", tfc.chain_phases_reference):
        ref_dx, *ref_dws = _vjp((32, 8, 8), ("TL",), cuda_device, b=7)
    assert (dx - ref_dx).abs().max().item() <= _tol(ref_dx.cpu().numpy())
    for d, r in zip(dws, ref_dws):
        assert (d - r).abs().max() <= 1e-4 * r.abs().max()


@pytest.mark.cuda
def test_flow_sample_kernel_matches_plain_chain(cuda_device):
    """A reduced ff_glow_mnist model (L=2 x K=2, width 16) samples on the
    card through the kernel, one launch per FincFlowUnit, and agrees with
    the same model on the plain chain on the same draws, before the final
    floor, to 1e-4 by norm."""
    gen = torch.Generator(cuda_device).manual_seed(0)
    flow = build_glow((1, 28, 28), step_kind="ff", num_blocks=2,
                      block_size=2, coupling_width=16, generator=gen,
                      device=cuda_device)
    x = torch.randint(0, 256, (16, 1, 28, 28), generator=gen,
                      device=cuda_device).float()
    flow.data_init(x, gen)
    body = Flow(flow.base_distribution, flow.layers[1:])
    noise = {"base": torch.randn((8, 8, 7, 7), generator=gen,
                                 device=cuda_device),
             5: torch.randn((8, 2, 14, 14), generator=gen,
                            device=cuda_device)}
    before = _counts()
    y = body.sample(8, noise=noise)
    torch.cuda.synchronize()
    _launched("cluster", 4, before)
    with mock.patch.object(tfc, "chain_phases", tfc.chain_phases_reference):
        ref = body.sample(8, noise=noise)
    assert torch.isfinite(y).all()
    assert ((y - ref).norm() / ref.norm()).item() <= 1e-4


# ---------------------------------------------------------------------------
# The SmoothLeakyRelu inverse kernel (csrc/slr_inverse.cu)
# ---------------------------------------------------------------------------

# imagenet32's three SLR shapes and real_digits_glow's two
SLR_SHAPES = [(12, 16, 16), (24, 8, 8), (48, 4, 4), (4, 4, 4), (8, 2, 2)]


def _slr_y(shape, seed=0):
    y = np.random.RandomState(seed).uniform(-40, 40, shape)
    y.reshape(-1)[:2] = [40.0, -40.0]
    return torch.from_numpy(y.astype(np.float32))


def test_slr_inverse_cpu_is_the_plain_loop():
    y = _slr_y((2, 4, 4, 4))
    before = tact.slr_inverse.launches
    assert torch.equal(tact.slr_inverse(y, 0.3),
                       tact.slr_inverse_reference(y, 0.3))
    assert tact.slr_inverse.launches == before
    with pytest.raises(ValueError):
        tact.slr_inverse(y.to("meta"), 0.3)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [100, 1])
@pytest.mark.parametrize("shape", SLR_SHAPES)
def test_slr_kernel_matches_plain_loop(cuda_device, shape, b):
    """One launch, against the plain loop on the card, within 1e-5 *
    max(1, max|y|) at |y| up to 40."""
    y = _slr_y((b,) + shape).to(cuda_device)
    before = tact.slr_inverse.launches
    x = tact.slr_inverse(y, 0.3)
    torch.cuda.synchronize()
    assert tact.slr_inverse.launches == before + 1
    ref = tact.slr_inverse_reference(y, 0.3)
    assert (x - ref).abs().max().item() <= 1e-5 * 40.0


@pytest.mark.cuda
def test_slr_kernel_floor_strides_and_checks(cuda_device):
    """alpha 0.005, where f' is floored (x up to 200 |y|: the limit scales
    with max|x|); a non-contiguous input; an empty one; float64 and a
    tensor that needs a gradient are refused."""
    y = _slr_y((100, 12, 16, 16), seed=1).to(cuda_device)
    x = tact.slr_inverse(y, 0.005)
    ref = tact.slr_inverse_reference(y, 0.005)
    assert (tact.slr_prime(ref, 0.005) < tact.FPRIME_FLOOR).any()
    assert (x - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    yt = y.transpose(1, 3)
    assert (tact.slr_inverse(yt, 0.3) - tact.slr_inverse_reference(
        yt, 0.3)).abs().max().item() <= 4e-4
    assert tact.slr_inverse(y[:0], 0.3).shape == (0, 12, 16, 16)
    with pytest.raises(TypeError):
        tact.slr_inverse(y.double(), 0.3)
    with pytest.raises(NotImplementedError):
        tact.slr_inverse(y.clone().requires_grad_(), 0.3)


# ---------------------------------------------------------------------------
# The SmoothTanh inverse kernel (csrc/slr_inverse.cu, TanhStep) and the
# layer zoo's models on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("beta", [0.1, 0.01])
@pytest.mark.parametrize("b", [100, 1])
@pytest.mark.parametrize("shape", SLR_SHAPES[:3])
def test_smooth_tanh_kernel_matches_plain_loop(cuda_device, shape, b, beta):
    """One launch at imagenet32's shapes, |y| up to 40, against the plain
    loop on the card, within ``smooth_tanh_inverse_limit`` at every
    element."""
    y = _slr_y((b,) + shape).to(cuda_device)
    before = tact.smooth_tanh_inverse.launches
    x = tact.smooth_tanh_inverse(y, 1.0, beta)
    torch.cuda.synchronize()
    assert tact.smooth_tanh_inverse.launches == before + 1
    hist = tact.smooth_tanh_inverse_history(y, 1.0, beta)
    assert ((x - hist[-1]).abs()
            <= tact.smooth_tanh_inverse_limit(y, hist, 1.0, beta)).all()
    assert (tact.smooth_tanh(x, 1.0, beta) - y).abs().max().item() <= 1e-5
    with pytest.raises(TypeError):
        tact.smooth_tanh_inverse(y.double(), 1.0, beta)
    assert tact.smooth_tanh_inverse(y[:0], 1.0, beta).shape == y[:0].shape


@pytest.mark.cuda
def test_fastflow_step_kernel_matches_plain_chain(cuda_device):
    """A reduced FastFlow ((3, 16, 16), 2 levels x 2 steps, width 16):
    log p(x) and the gradients of its mean through the kernel (4 launches
    forward, 4 backward, all ``cluster``) against the plain chain, 1e-4
    by norm."""
    from inverse_flow_tpu_torch.models.fastflow import build_fastflow

    gen = torch.Generator(cuda_device).manual_seed(0)
    flow = build_fastflow((3, 16, 16), n_blocks=2, block_size=2,
                          coupling_width=16, generator=gen,
                          device=cuda_device)
    x = torch.randint(0, 256, (8, 3, 16, 16), generator=gen,
                      device=cuda_device).float()
    flow.data_init(x, gen)
    body = Flow(flow.base_distribution, flow.layers[1:])
    xd = x + torch.rand(x.shape, generator=gen, device=cuda_device)
    params = list(body.parameters())

    def grads():
        lp = body(xd)[1]
        return (lp,) + torch.autograd.grad(lp.mean(), params)

    before = _counts()
    lp, *g = grads()
    torch.cuda.synchronize()
    _launched("cluster", 8, before)
    with mock.patch.object(tfc, "chain_phases", tfc.chain_phases_reference):
        lp_ref, *g_ref = grads()
    assert torch.isfinite(lp).all()
    assert ((lp - lp_ref).abs() / lp_ref.abs()).max().item() <= 1e-4
    for a, r in zip(g, g_ref):
        assert (a - r).norm().item() <= 1e-4 * max(r.norm().item(), 1e-6)


@pytest.mark.cuda
def test_exponential_cnn_step_matches_the_cpu(cuda_device, tmp_path):
    """A reduced exponential_cnn_mnist (2 blocks x 2 ConvExp, (1, 8, 8)):
    one train step on the card and on the CPU from the same weights; the
    loss, every weight and every u after the step to 1e-4 by norm."""
    from inverse_flow_tpu_torch.data.loader import ArrayLoader
    from inverse_flow_tpu_torch.models.glow import build_cnn_flow
    from inverse_flow_tpu_torch.train.config import ExperimentConfig
    from inverse_flow_tpu_torch.train.experiment import Experiment

    flow = build_cnn_flow((1, 8, 8), step_kind="convexp", num_blocks=2,
                          block_size=2, activation="Spline", tail_bound=10.0,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    data = np.random.RandomState(0).randint(0, 256, (8, 1, 8, 8)).astype(
        np.float32)
    flow.data_init(torch.from_numpy(data), torch.Generator().manual_seed(1))
    cfg = ExperimentConfig(name="convexp", lr=1e-3, batch_size=8,
                           modified_grad=False, add_recon_grad=False,
                           scheduler_name="None", log_timing=False,
                           save_images=False, plot_recon=False,
                           metrics_path=str(tmp_path / "m.jsonl"))
    losses, states = [], []
    for device in ("cpu", cuda_device):
        exp = Experiment(copy.deepcopy(flow).to(device),
                         *(ArrayLoader(data, 8) for _ in range(3)), cfg,
                         device=device)
        exp._data_initialized = True
        body = Flow(exp.flow.base_distribution, exp.flow.layers[1:])
        xd = torch.from_numpy(data + 0.5).to(device)
        with mock.patch.object(exp, "flow", body):
            losses.append(float(exp.train_step(xd)))
        states.append({k: v.cpu() for k, v in exp.flow.state_dict().items()})
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[0])
    for k, v in states[0].items():
        assert (states[1][k] - v).norm() <= 1e-4 * max(v.norm(), 1e-6), k


@pytest.mark.cuda
def test_a_wrapped_chain_still_counts_on_the_kernel(cuda_device):
    """With a wrapper bound to ``fused_chain.chain_phases`` (the bench's
    FLOP count, ``bench.step_flops``), each launch still counts on the
    kernel's own counts: a solve forward and backward, 2 launches, and
    the count's chain FLOPs those of ``chain_work``."""
    from inverse_flow_tpu_torch import bench

    xs, ws = _inputs((4, 14, 14), 1, b=4, seed=3)
    x = torch.from_numpy(xs).to(cuda_device).requires_grad_()
    w = apply_mask(torch.from_numpy(ws[0]).to(cuda_device)).detach()
    w.requires_grad_()
    args = tfc.chain_inputs(x.detach(), (w.detach(),), ("TL",))
    before = _counts()
    _, chain_flops, n = bench.step_flops(
        lambda: tfc.fused_chain_solve(x, [w], ("TL",)).sum().backward())
    torch.cuda.synchronize()
    assert n == 2
    assert chain_flops >= 2 * tfc.chain_work(args)[0] * 4
    _launched("cluster", 2, before)
