"""The coupling nets' conv3x3 -> ReLU -> conv1x1 op
(``ops/coupling_net.py``) and its kernels (``csrc/coupling_net.cu``).

On the CPU:

* the kernels' arithmetic written out in plain torch (:func:`kernel_math`:
  the patch matrix in the kernels' k order, a = patch W1^T, h, the output,
  dh, da, dW1 = da^T patch, dW2 = g^T h, the patch gradient da W1 and its
  col2im gather) against the op's plain version and its autograd, in
  float64, at the flagship's two net shapes, an imagenet32 shape (K=216,
  width 128, C=48) and a ``SplitPriorFC`` shape on 1x1 images;
* ``Coupling`` (and ``SplitPrior``) forward, inverse and gradients equal
  the ``F.conv2d`` composition's bit for bit on the CPU, with and without
  ``remat_net``;
* a bf16 net never calls the op; the launch counter stays at 0 on the CPU.

On the card (``cuda``-marked, skipped without one; the card is decided
inside the test): every distinct float32 net shape of ``bench.py``'s ten
configurations, forward and backward, against the float64 composition;
a small batch splits the width; two backward runs give bitwise-equal
gradients; the flagship's train step and draw count their launches. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_coupling_net.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from inverse_flow_tpu_torch import layers as tl
from inverse_flow_tpu_torch.layers import coupling as tcoupling
from inverse_flow_tpu_torch.ops import coupling_net as tcn

# (B, Cin, H, W, width N, C): the flagship's two levels, an imagenet32
# level-3 net, a SplitPriorFC net on 1x1 images
CPU_SHAPES = [(2, 2, 14, 14, 512, 4), (2, 4, 7, 7, 512, 8),
              (2, 24, 4, 4, 128, 48), (3, 6, 1, 1, 16, 12)]
CPU_IDS = ["flagship-l1", "flagship-l2", "imagenet32-l3", "splitprior-fc"]


def _operands(shape, dtype=torch.float64, device="cpu", seed=0):
    """x1, w1 (nn.Conv2d's init scale), w2, and a cotangent g. x1 and w1
    lie on the grids of 1/8 and 1/64 (|x1| < 4), so that every hidden
    pre-activation, a sum of at most a few hundred such products, is
    exact in float32: the ReLU then masks the same entries in float32 and
    in float64. (On random floats a few of the 10^8-10^9 pre-activations
    of a B=8192 net lie within float32's rounding of 0 and take the other
    side of the ReLU, each moving a patch gradient by O(1).)"""
    b, cin, h, w, n, c = shape
    rs = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(a).to(dtype=dtype, device=device)

    x1 = t(np.clip(np.round(8 * rs.randn(b, cin, h, w)), -31, 31) / 8)
    w1 = t(np.round(64 * rs.uniform(-1, 1, (n, cin, 3, 3))
                    / np.sqrt(9 * cin)) / 64)
    w2 = t(rs.uniform(-1, 1, (c, n, 1, 1)) / np.sqrt(n))
    g = t(rs.randn(b, c, h, w))
    return x1, w1, w2, g


def kernel_math(x1, w1, w2, g):
    """(out, dx1, dw1, dw2) computed the kernels' way: per pixel p =
    (b, y, x) the patch k = ci*9 + dy*3 + dx, a = patch W1^T, h = relu(a),
    out = h W2^T; backward da = (g W2) [a > 0], dW1 = da^T patch, dW2 =
    g^T h, the patch gradient da W1, and x1's gradient gathered from it:
    each element sums the taps (dy, dx) of the pixels (y - dy + 1,
    x - dx + 1) that read it."""
    b, cin, h, w = x1.shape
    n, c = w1.shape[0], w2.shape[0]
    xp = F.pad(x1, (1, 1, 1, 1))
    taps = [xp[:, :, dy:dy + h, dx:dx + w] for dy in range(3)
            for dx in range(3)]
    patch = torch.stack(taps, 2).reshape(b, cin * 9, h * w)
    patch = patch.permute(0, 2, 1).reshape(-1, cin * 9)       # (P, K)
    w1m, w2m = w1.reshape(n, -1), w2.reshape(c, n)
    a = patch @ w1m.T
    hid = a.clamp(min=0)
    out = (hid @ w2m.T).reshape(b, h * w, c).permute(0, 2, 1)
    gp = g.reshape(b, c, h * w).permute(0, 2, 1).reshape(-1, c)
    da = (gp @ w2m) * (a > 0)
    dw1 = (da.T @ patch).reshape(w1.shape)
    dw2 = (gp.T @ hid).reshape(w2.shape)
    dpatch = (da @ w1m).reshape(b, h, w, cin, 3, 3)
    dx1 = torch.zeros_like(x1)
    for dy in range(3):
        for dx in range(3):
            # pixel (y', x') read x1 at (y' + dy - 1, x' + dx - 1)
            src = F.pad(dpatch[..., dy, dx].permute(0, 3, 1, 2),
                        (1, 1, 1, 1))
            dx1 += src[:, :, 2 - dy:2 - dy + h, 2 - dx:2 - dx + w]
    return out.reshape(b, c, h, w), dx1, dw1, dw2


@pytest.mark.parametrize("shape", CPU_SHAPES, ids=CPU_IDS)
def test_kernel_math_matches_the_plain_version(shape):
    x1, w1, w2, g = _operands(shape)
    x1.requires_grad_(True)
    w1.requires_grad_(True)
    w2.requires_grad_(True)
    out = tcn.coupling_net_hidden(x1, w1, w2)
    ref = F.conv2d(F.relu(F.conv2d(x1, w1, padding=1)), w2)
    assert torch.equal(out, ref)
    grads = torch.autograd.grad(out, (x1, w1, w2), g)
    mine = kernel_math(x1.detach(), w1.detach(), w2.detach(), g)
    for name, m, r in zip(("out", "dx1", "dw1", "dw2"), mine,
                          (out.detach(), *grads)):
        assert m.shape == r.shape, name
        scale = max(1.0, r.abs().max().item())
        assert (m - r).abs().max().item() <= 1e-12 * scale, name


def _old_net(layer, p, x1):
    """``Coupling._net`` as the F.conv2d composition, the first two convs
    included."""
    h = F.relu(F.conv2d(x1, p["w1"], padding=1))
    h = F.relu(F.conv2d(h, p["w2"]))
    h = F.conv2d(h, p["w3"], p["b3"], padding=1)
    return h * torch.exp(p["logs3"] * layer.logscale_factor).reshape(
        1, -1, 1, 1)


def _coupling(kind, remat, size=(4, 6, 6), width=16):
    gen = torch.Generator().manual_seed(0)
    cls = tl.SplitPrior if kind == "prior" else tl.Coupling
    layer = cls(size, width=width, remat_net=remat, generator=gen)
    with torch.no_grad():
        # a nonzero last conv, so that every weight has a gradient
        for name in ("w3", "b3", "logs3"):
            getattr(layer, name).normal_(0, 0.05, generator=gen)
    return layer


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("kind", ["coupling", "prior"])
def test_coupling_unchanged_on_cpu(kind, remat, monkeypatch):
    layer = _coupling(kind, remat)
    x = torch.randn(3, 4, 6, 6, generator=torch.Generator().manual_seed(1))

    def run():
        layer.zero_grad()
        z, ldj = layer(x)
        (z.square().sum() + ldj.sum()).backward()
        grads = {k: v.grad.clone() for k, v in layer.named_parameters()}
        if kind == "coupling":
            with torch.no_grad():
                back = layer.inverse(z)
        else:
            back = None
        return z.detach(), ldj.detach(), grads, back

    new = run()
    monkeypatch.setattr(tcoupling.Coupling, "_net", _old_net)
    old = run()
    assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])
    for k in old[2]:
        assert torch.equal(new[2][k], old[2][k]), k
    if kind == "coupling":
        assert torch.equal(new[3], old[3])
        assert (new[3] - x).abs().max().item() < 1e-5


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_only_float32_nets_call_the_op(dtype, monkeypatch):
    calls = []

    def spy(x1, w1, w2):
        calls.append(tuple(x1.shape))
        return tcn.coupling_net_reference(x1, w1, w2)

    monkeypatch.setattr(tcoupling, "coupling_net_hidden", spy)
    layer = tl.Coupling((4, 6, 6), width=16, compute_dtype=dtype,
                        generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 4, 6, 6)
    z, _ = layer(x)
    layer.inverse(z.detach())
    assert calls == ([] if dtype == "bfloat16" else [(2, 2, 6, 6)] * 2)


def test_counter_stays_at_zero_on_cpu():
    tcn.reset_launches()
    layer = _coupling("coupling", True)
    z, ldj = layer(torch.randn(2, 4, 6, 6))
    (z.sum() + ldj.sum()).backward()
    assert tcn.coupling_net_hidden.launches == 0
    assert tcn.coupling_net_hidden.launches_by_kind == dict.fromkeys(
        tcn.KINDS, 0)


def _cpu_forward(x1, w1, w2):
    """The kernel forward's stand-in on the CPU: the plain version."""
    with torch.no_grad():
        return tcn.coupling_net_reference(x1, w1, w2)


def _cpu_backward(x1, w1, w2, g, need_dx):
    """The kernel backward's stand-in on the CPU: the plain version's
    autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x1, w1, w2)]
        grads = torch.autograd.grad(tcn.coupling_net_reference(*leaves),
                                    leaves, g)
    return (grads[0] if need_dx else None), grads[1], grads[2]


@pytest.mark.parametrize("name", ["glow_mnist", "imagenet32"])
def test_step_flops_count_a_kernel_call_as_the_composition(name,
                                                           monkeypatch):
    """``bench.step_flops`` counts a step whose nets run through
    :class:`CouplingNet` (which ``FlopCounterMode`` cannot see into; here
    its forward and backward are CPU stand-ins) exactly as the same step
    on the ``F.conv2d`` composition, forward, checkpoint recompute and
    backward."""
    from inverse_flow_tpu_torch import bench
    from inverse_flow_tpu_torch.data import synthetic
    from inverse_flow_tpu_torch.experiments import bench_configs

    gen = torch.Generator().manual_seed(0)
    flow, shape, _ = bench_configs.build(name, "cpu", gen, num_blocks=1,
                                         block_size=2, coupling_width=8)
    x = torch.from_numpy(synthetic.smooth_images(4, shape))
    flow.data_init(x, gen)
    step = bench.train_step_fn(flow, x, gen)
    plain = bench.step_flops(step)
    calls = []

    def through_the_op(x1, w1, w2):
        calls.append(tuple(x1.shape))
        return tcn.CouplingNet.apply(x1, w1, w2)

    monkeypatch.setattr(tcoupling, "coupling_net_hidden", through_the_op)
    monkeypatch.setattr(tcn, "_forward", _cpu_forward)
    monkeypatch.setattr(tcn, "_backward", _cpu_backward)
    assert bench.step_flops(step) == plain
    assert calls and plain[0] > 0


@pytest.mark.parametrize("need_dx", [True, False], ids=["dx", "no-dx"])
def test_composition_flops_are_the_counters(need_dx):
    """``composition_flops`` equals ``FlopCounterMode``'s count of the
    composition's forward and of its backward."""
    from torch.utils.flop_counter import FlopCounterMode

    x1, w1, w2, g = _operands(CPU_SHAPES[2], torch.float32)
    x1.requires_grad_(need_dx)
    w1.requires_grad_(True)
    w2.requires_grad_(True)
    with FlopCounterMode(display=False) as fwd:
        out = tcn.coupling_net_reference(x1, w1, w2)
    with FlopCounterMode(display=False) as bwd:
        out.backward(g)
    assert tcn.composition_flops(x1, w1, w2, need_dx) == (
        fwd.get_total_flops(), bwd.get_total_flops())


@pytest.mark.parametrize("bad", ["w1-kernel", "w2-width", "x1-channels"])
def test_unsupported_shapes_raise(bad):
    x1, w1, w2, _ = _operands((2, 2, 5, 5, 8, 4), torch.float32)
    if bad == "w1-kernel":
        w1 = w1[:, :, :2]
    elif bad == "w2-width":
        w2 = w2[:, :4]
    else:
        x1 = torch.cat([x1, x1], 1)
    with pytest.raises(ValueError):
        tcn._shape(x1, w1, w2)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# every distinct float32 net of bench.py's ten configurations, (Cin, width,
# C, H, W) at their batch of 100: glow_mnist (and its fused-units variant)
# at both levels, imagenet32 (and imagenet32_exact) at its three; the
# SplitPriorFC zoo net, the flagship's level-1 net on a 2-way model mesh's
# slice of the width, and an odd shape (width not a multiple of the chunk,
# C not of 4)
CARD_SHAPES = [(100, 2, 14, 14, 512, 4), (100, 4, 7, 7, 512, 8),
               (100, 6, 16, 16, 128, 12), (100, 12, 8, 8, 128, 24),
               (100, 24, 4, 4, 128, 48), (100, 6, 1, 1, 16, 12),
               (100, 2, 14, 14, 256, 4), (7, 3, 5, 6, 100, 5)]
CARD_IDS = ["glow-l1", "glow-l2", "in32-l1", "in32-l2", "in32-l3",
            "splitprior-fc", "mesh-slice", "odd"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return (a.double() - b).abs().max().item() / max(
        1e-30, b.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=CARD_IDS)
def test_kernels_against_float64(shape, cuda_device):
    """Forward and backward against the float64 composition on the card.
    Tolerances: the output and dx1 sum K + N (dx1: 9 x N) float32 products
    of order-1 terms, so their error is float32 rounding of such sums,
    under 2e-5 of the largest entry; dW1 and dW2 sum B*H*W pixels (up to
    19,600), under 1e-4 of the largest entry (the chain kernel's tests take
    the same for its weight gradients)."""
    x1, w1, w2, g = _operands(shape, torch.float32, cuda_device)
    x64, w164, w264, g64 = (t.double() for t in (x1, w1, w2, g))
    for t in (x1, w1, w2, x64, w164, w264):
        t.requires_grad_(True)
    tcn.reset_launches()
    out = tcn.coupling_net_hidden(x1, w1, w2)
    grads = torch.autograd.grad(out, (x1, w1, w2), g)
    torch.cuda.synchronize()
    assert tcn.coupling_net_hidden.launches_by_kind == {
        "forward": -(-shape[5] // 64), "backward": 1, "reduce": 1}
    ref = tcn.coupling_net_reference(x64, w164, w264)
    rgrads = torch.autograd.grad(ref, (x64, w164, w264), g64)
    assert _rel(out, ref) <= 2e-5
    assert _rel(grads[0], rgrads[0]) <= 2e-5
    assert _rel(grads[1], rgrads[1]) <= 1e-4
    assert _rel(grads[2], rgrads[2]) <= 1e-4


@pytest.mark.cuda
def test_a_small_batch_splits_the_width(cuda_device):
    """At the flagship's level 2 at B=100 (39 backward tiles, 10 forward
    tiles) the plan splits the width in both kernels; the result matches
    the float64 composition as at the unsplit B=8192 (phase 20 of
    chip_smoke.py)."""
    x1, w1, w2, g = _operands(CARD_SHAPES[1], torch.float32, cuda_device)
    p = tcn.plan(x1, w1, w2)
    assert p["fwd_split"] > 1 and p["bwd_split"] > 1
    big = torch.empty(8192, *x1.shape[1:], device=cuda_device)
    q = tcn.plan(big, w1, w2)
    assert q["fwd_split"] == 1 and q["bwd_split"] == 1
    x64, w164, w264 = (t.double().requires_grad_(True) for t in (x1, w1, w2))
    ref = tcn.coupling_net_reference(x64, w164, w264)
    rgrads = torch.autograd.grad(ref, (x64, w164, w264), g.double())
    out = tcn._forward(x1, w1, w2)
    grads = tcn._backward(x1, w1, w2, g, True)
    assert _rel(out, ref) <= 2e-5
    for a, r, tol in zip(grads, rgrads, (2e-5, 1e-4, 1e-4)):
        assert _rel(a, r) <= tol


@pytest.mark.cuda
def test_strided_x1_is_taken_as_it_lies(cuda_device):
    """A channel slice of a wider tensor (what Coupling hands the net)
    gives the result of its contiguous copy, bit for bit."""
    x, w1, w2, g = _operands((16, 4, 14, 14, 512, 4), torch.float32,
                             cuda_device)
    w1 = w1[:, :2].contiguous()
    x1 = x[:, :2]
    assert not x1.is_contiguous()
    out = tcn.coupling_net_hidden(x1, w1, w2)
    assert torch.equal(out, tcn.coupling_net_hidden(x1.contiguous(), w1,
                                                    w2))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES[:2], ids=CARD_IDS[:2])
def test_backward_repeats_bit_for_bit(shape, cuda_device):
    x1, w1, w2, g = _operands(shape, torch.float32, cuda_device)
    runs = [tcn._backward(x1, w1, w2, g, True) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


class _Feed:
    """A train loader as ``Experiment`` reads one: batch size, image shape
    and epoch length."""

    def __init__(self, batch, shape):
        self.batch_size, self.data_shape = batch, shape

    def __len__(self):
        return 1

    def __iter__(self):
        return iter(())


@pytest.mark.cuda
def test_flagship_launch_counts(cuda_device):
    """glow_mnist's 33 float32 nets (32 couplings, 1 SplitPrior): a train
    step launches the forward kernel 66 times (the forward and the
    checkpoint's recompute), the backward and the reduction 33 times each;
    a draw launches the forward 33 times."""
    from inverse_flow_tpu_torch.experiments import bench_configs
    from inverse_flow_tpu_torch.train.config import ExperimentConfig
    from inverse_flow_tpu_torch.train.experiment import Experiment

    gen = torch.Generator(cuda_device).manual_seed(0)
    flow, shape, _ = bench_configs.build("glow_mnist", device=cuda_device,
                                         generator=gen)
    cfg = ExperimentConfig(name="glow_mnist", seed=0, save_images=False,
                           log_timing=False, plot_recon=False, batch_size=64)
    exp = Experiment(flow, _Feed(64, shape), None, None, cfg,
                     device=cuda_device)
    x = torch.randint(0, 256, (64, *shape), generator=gen,
                      device=cuda_device).float()
    exp.train_step(x)
    torch.cuda.synchronize()
    tcn.reset_launches()
    exp.train_step(x)
    torch.cuda.synchronize()
    assert tcn.coupling_net_hidden.launches_by_kind == {
        "forward": 66, "backward": 33, "reduce": 33}
    tcn.reset_launches()
    with torch.no_grad():
        flow.sample(16, gen)
    torch.cuda.synchronize()
    assert tcn.coupling_net_hidden.launches_by_kind == {
        "forward": 33, "backward": 0, "reduce": 0}
