"""Plain PyTorch reference of the benchmark's Glow models.

The Glow of the Inverse-Flow paper (Table 3) and its ImageNet32
Inv-Flow-Unit variant, written from the model's equations with plain
torch operations. It imports nothing of the measured program and runs
none of its kernels: each masked convolution is solved as a dense unit
lower-triangular operator (``torch.linalg.solve_triangular``) in the
pixel-major raster order, independently of the program's row-blocked
chain, and the optimizer is Adam written out.

Layer order, as the configuration states it: Dequantization (uniform
noise) -> Normalization(0, 256) -> Normalization(-alpha, 1 / (1 - 2 alpha))
-> logit -> per level [squeeze -> K x (ActNorm, masked-conv inverse,
activation, affine coupling) -> SplitPrior but after the last level] ->
standard normal prior. Parameters carry the names under which the
program's ``state_dict`` holds them, with the K steps of a level stacked
on a leading axis.

``control=True`` computes every float32 convolution and solve of the
configuration one precision lower, in TF32: each operand rounded to a
10-bit mantissa, products accumulated in float32 (the gradients flowing
back through those operations are rounded too). It is the benchmark's
control: a program that computed there would have to fail the
comparison. bf16 coupling nets stay bf16.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LOG_2PI = math.log(2.0 * math.pi)
ORDERS = {"inv_conv_no_pad": ("TL",), "inv_flow_unit": ("TL", "TR", "BL", "BR")}
FLIPS = {"TL": (), "TR": (3,), "BL": (2,), "BR": (2, 3)}
MIN_BIN = 1e-6
MIN_DERIV = 1e-6
SLR_ALPHA = 0.3
LOGSCALE_FACTOR = 3.0
# make_weights' scales: the spline knots' std, the masked-conv taps' std
# times sqrt(fan_in), a coupling's last conv as a share of 'kaiming', the
# coupling's bias and log-scale std
SCALES = {"knots": 0.01, "tap": 0.01, "out": 0.01, "small": 0.01}


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

def _round_tf32_raw(x):
    """float32 -> nearest value with a 10-bit mantissa (round half away)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_tf32_raw(x)

    @staticmethod
    def backward(ctx, g):
        return _round_tf32_raw(g)


def tf32(x):
    return _TF32.apply(x) if x.dtype == torch.float32 else x


# ---------------------------------------------------------------------------
# model description
# ---------------------------------------------------------------------------

def levels(model, data_shape):
    """[(C, H, W) of each level's steps, whether a SplitPrior follows]."""
    c, h, w = data_shape
    out = []
    for level in range(model["num_blocks"]):
        c, h, w = c * 4, h // 2, w // 2
        split = model["split_prior"] and level < model["num_blocks"] - 1
        out.append(((c, h, w), split))
        if split:
            c = c // 2
    return out


def layer_plan(model, data_shape):
    """The program's layer list as (index, kind, size): kind is one of
    'deq', 'norm', 'logit', 'squeeze', 'block', 'split'."""
    plan = [(0, "deq", None), (1, "norm", None), (2, "norm", None),
            (3, "logit", None)]
    for size, split in levels(model, data_shape):
        plan.append((len(plan), "squeeze", None))
        plan.append((len(plan), "block", size))
        if split:
            plan.append((len(plan), "split", size))
    return plan


def final_shape(model, data_shape):
    size, split = levels(model, data_shape)[-1]
    return size


def split_shapes(model, data_shape):
    """{layer index: (C/2, H, W)} of each SplitPrior's factored-out half."""
    return {i: (s[0] // 2, s[1], s[2])
            for i, kind, s in layer_plan(model, data_shape) if kind == "split"}


def _coupling_specs(prefix, c, width, lead):
    return [(f"{prefix}w1", lead + (width, c // 2, 3, 3), "kaiming"),
            (f"{prefix}w2", lead + (c, width, 1, 1), "kaiming"),
            (f"{prefix}w3", lead + (c, c, 3, 3), "out"),
            (f"{prefix}b3", lead + (c,), "small"),
            (f"{prefix}logs3", lead + (c,), "small")]


def param_specs(model, data_shape):
    """[(name, shape, kind)] of every parameter, in the program's order.
    kind: 'normal' (std 1), 'small' (std 0.01), 'knots' (std 0.5),
    'tap' (std 0.3 / sqrt(fan_in)), 'kaiming' (uniform, +-1/sqrt(fan_in)),
    'out' (a coupling's last conv: a tenth of 'kaiming')."""
    specs = []
    k_steps, width = model["block_size"], model["coupling_width"]
    nb = model["n_bins"]
    for i, kind, size in layer_plan(model, data_shape):
        if kind == "block":
            c, h, w = size
            lead = (k_steps,)
            p = f"layers.{i}.steps."
            specs += [(f"{p}0.translation", lead + (c,), "normal"),
                      (f"{p}0.log_scale", lead + (c,), "normal")]
            if model["step_kind"] == "inv_conv_no_pad":
                specs.append((f"{p}1.w", lead + (c, c, 3, 3), "tap"))
            else:
                specs += [(f"{p}1.convs.{o}.w", lead + (c, c, 3, 3), "tap")
                          for o in range(4)]
            if model["activation"] == "Spline":
                pos = lead + (1, c, h, w)
                specs += [(f"{p}2.widths", pos + (nb,), "knots"),
                          (f"{p}2.heights", pos + (nb,), "knots"),
                          (f"{p}2.derivs", pos + (nb - 1,), "knots")]
            elif model["activation"] != "SLR":
                raise ValueError(f"activation {model['activation']!r}")
            specs += _coupling_specs(f"{p}3.", c, width, lead)
        elif kind == "split":
            specs += _coupling_specs(f"layers.{i}.", size[0], width, ())
    return specs


def make_weights(model, data_shape, generator, device):
    """Every parameter drawn from ``generator`` in two large calls (one
    normal, one uniform draw over all leaves), float32 on ``device``.
    The distributions are the model's own initialisation (the masked
    convs' taps xavier noise at gain 0.01, the spline knots 0.01 noise,
    the nets' first convs PyTorch's kaiming-uniform; ActNorm is set by
    data init), except a coupling's last conv, bias and log-scale, zero at
    init, which are drawn small and nonzero (``SCALES``) so that the nets
    reach the output and every leaf has a gradient at the first step.
    Larger draws make the 32-144-step stacks overflow for inputs other
    than the data-init batch's."""
    specs = param_specs(model, data_shape)
    sizes = [int(np.prod(s)) for _, s, _ in specs]
    normal = torch.randn(sum(sizes), generator=generator, device=device)
    uniform = torch.rand(sum(sizes), generator=generator, device=device)
    out, at = {}, 0
    for (name, shape, kind), n in zip(specs, sizes):
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if kind == "normal":
            t = z
        elif kind == "small":
            t = SCALES["small"] * z
        elif kind == "knots":
            t = SCALES["knots"] * z
        elif kind == "tap":
            t = SCALES["tap"] / math.sqrt(shape[-3] * shape[-2] * shape[-1]) * z
        else:
            bound = 1.0 / math.sqrt(shape[-3] * shape[-2] * shape[-1])
            t = (2 * u - 1) * bound * (SCALES["out"] if kind == "out" else 1.0)
        out[name] = t.clone()
    return out


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def squeeze(x):
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(b, c * 4, h // 2, w // 2)


def unsqueeze(x):
    b, c, h, w = x.shape
    x = x.reshape(b, c // 4, 2, 2, h, w)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(b, c // 4, h * 2, w * 2)


def masked_kernel(w):
    """w (C, C, 3, 3) -> its masked form: the centre tap unit lower
    triangular over channels (diagonal 1, above it 0)."""
    c = w.shape[0]
    keep = torch.ones_like(w)
    keep[:, :, -1, -1] = torch.tril(torch.ones(c, c, device=w.device), -1)
    eye = torch.zeros_like(w)
    eye[:, :, -1, -1] = torch.eye(c, device=w.device)
    return w * keep + eye


_INDEX = {}


def _operator_index(c, h, w, device):
    """(rows, cols, taps) of the masked conv's nonzero-able entries in the
    raster order p = (y * W + x) * C + c: output p reads input q at
    (y - 2 + i, x - 2 + j, c') through tap w[c, c', i, j]."""
    key = (c, h, w, str(device))
    if key not in _INDEX:
        cc, cp, i, j = np.meshgrid(np.arange(c), np.arange(c), np.arange(3),
                                   np.arange(3), indexing="ij")
        rows, cols, taps = [], [], []
        for y in range(h):
            for x in range(w):
                sy, sx = y - 2 + i, x - 2 + j
                ok = (sy >= 0) & (sx >= 0)
                rows.append(((y * w + x) * c + cc)[ok])
                cols.append(((sy * w + sx) * c + cp)[ok])
                taps.append((((cc * c + cp) * 3 + i) * 3 + j)[ok])
        _INDEX[key] = tuple(torch.as_tensor(np.concatenate(a),
                                            device=device)
                            for a in (rows, cols, taps))
    return _INDEX[key]


def dense_operator(w_eff, c, h, w):
    """The masked conv as a dense (HWC, HWC) unit lower-triangular
    matrix."""
    rows, cols, taps = _operator_index(c, h, w, w_eff.device)
    n = c * h * w
    vals = w_eff.reshape(-1)[taps]
    flat = torch.zeros(n * n, dtype=w_eff.dtype, device=w_eff.device)
    return flat.index_put((rows * n + cols,), vals).reshape(n, n)


def solve_tl(x, w_eff, control):
    """y with masked_conv(y) = x, TL orientation: a dense triangular
    solve per image."""
    b, c, h, w = x.shape
    t = dense_operator(w_eff, c, h, w)
    rhs = x.permute(0, 2, 3, 1).reshape(b, -1).T
    if control:
        t, rhs = tf32(t), tf32(rhs)
    y = torch.linalg.solve_triangular(t, rhs, upper=False)
    return y.T.reshape(b, h, w, c).permute(0, 3, 1, 2)


def masked_conv(y, w_eff, control):
    """x = masked_conv(y), TL orientation (zero padding above, left)."""
    if control:
        y, w_eff = tf32(y), tf32(w_eff)
    return F.conv2d(F.pad(y, (2, 0, 2, 0)), w_eff)


def _flip(x, order):
    return x.flip(FLIPS[order]) if FLIPS[order] else x


def rq_spline(x, uw, uh, ud, bound, inverse=False):
    """Rational-quadratic spline on [-bound, bound] with identity tails
    (Durkan et al. 2019), elementwise; the knots broadcast against
    ``x[..., None]``. Returns (y, log|dy/dx|) (of the inverse map when
    ``inverse``)."""
    nb = uw.shape[-1]
    inside = (x >= -bound) & (x <= bound)
    xc = x.clamp(-bound, bound)
    ud = F.pad(ud, (1, 1)) + math.log(math.expm1(1.0 - MIN_DERIV))

    def knots(u):
        s = MIN_BIN + (1 - MIN_BIN * nb) * torch.softmax(u, -1)
        cum = F.pad(torch.cumsum(s, -1), (1, 0)) * 2 * bound - bound
        cum = torch.cat([torch.full_like(cum[..., :1], -bound),
                         cum[..., 1:-1],
                         torch.full_like(cum[..., :1], bound)], -1)
        return cum[..., 1:] - cum[..., :-1], cum

    widths, cw = knots(uw)
    heights, ch = knots(uh)
    derivs = MIN_DERIV + F.softplus(ud)
    delta = heights / widths
    edges = (ch if inverse else cw).clone()
    edges[..., -1] += 1e-6
    idx = ((xc[..., None] >= edges).sum(-1) - 1).clamp(0, nb - 1)[..., None]

    def pick(t):
        return torch.gather(t.expand(x.shape + t.shape[-1:]), -1, idx)[..., 0]

    x0, bw, y0 = pick(cw[..., :-1]), pick(widths), pick(ch[..., :-1])
    dl, d0, d1, bh = pick(delta), pick(derivs[..., :-1]), \
        pick(derivs[..., 1:]), pick(heights)
    ds = d0 + d1 - 2 * dl
    if inverse:
        dy = xc - y0
        a = dy * ds + bh * (dl - d0)
        bq = bh * d0 - dy * ds
        cq = -dl * dy
        theta = 2 * cq / (-bq - torch.sqrt((bq * bq - 4 * a * cq).clamp_min(0)))
        y = theta * bw + x0
    else:
        theta = (xc - x0) / bw
    tt = theta * (1 - theta)
    den = dl + ds * tt
    if not inverse:
        y = y0 + bh * (dl * theta ** 2 + d0 * tt) / den
    lad = torch.log(dl ** 2 * (d1 * theta ** 2 + 2 * dl * tt
                               + d0 * (1 - theta) ** 2)) - 2 * torch.log(den)
    if inverse:
        lad = -lad
    return torch.where(inside, y, x), torch.where(inside, lad, 0.0)


def _conv(x, w, b, padding, dtype, control, record):
    if record is not None:
        record.append((tuple(x.shape), tuple(w.shape), dtype))
    if dtype == torch.float32:
        if control:
            x, w = tf32(x), tf32(w)
        return F.conv2d(x, w, b, padding=padding)
    out = F.conv2d(x.to(dtype), w.to(dtype), padding=padding).float()
    return out + b.reshape(1, -1, 1, 1) if b is not None else out


class Reference:
    """The model on ``weights`` (name -> float32 tensor; updated in place
    by :meth:`data_init` and :meth:`adam_step`)."""

    def __init__(self, config, weights, control=False):
        self.model = config["model"]
        self.data_shape = tuple(config["data_shape"])
        self.w = weights
        self.control = control
        self.net_dtype = (torch.bfloat16 if self.model["coupling_dtype"]
                          in ("bfloat16", "bf16") else torch.float32)
        self.orders = ORDERS[self.model["step_kind"]]
        self.plan = layer_plan(self.model, self.data_shape)
        self.record = None          # a list collects the convs' shapes
        self.adam = {}

    # -- the layers ---------------------------------------------------------
    def _net(self, p, x1):
        dt, ctl, rec = self.net_dtype, self.control, self.record
        h = F.relu(_conv(x1, p["w1"], None, 1, dt, ctl, rec))
        h = F.relu(_conv(h, p["w2"], None, 0, dt, ctl, rec))
        h = _conv(h, p["w3"], p["b3"], 1, dt, ctl, rec)
        return h * torch.exp(p["logs3"] * LOGSCALE_FACTOR).reshape(1, -1, 1, 1)

    def _coupling(self, p, x, inverse=False):
        half = x.shape[1] // 2
        x1, x2 = x[:, :half], x[:, half:]
        h = self._net(p, x1)
        log_s, t = 2.0 * torch.tanh(h[:, ::2] / 2.0), h[:, 1::2]
        if inverse:
            return torch.cat([x1, (x2 - t) * torch.exp(-log_s)], 1), None
        return torch.cat([x1, x2 * torch.exp(log_s) + t], 1), \
            log_s.reshape(x.shape[0], -1).sum(-1)

    def _step_params(self, i, k):
        head = f"layers.{i}.steps."
        out = {}
        for name, t in self.w.items():
            if name.startswith(head):
                j, _, leaf = name[len(head):].partition(".")
                out.setdefault(int(j), {})[leaf] = t[k]
        return [out[j] for j in sorted(out)]

    def _solve(self, p, x, inverse=False):
        keys = ["w"] if len(self.orders) == 1 else \
            [f"convs.{o}.w" for o in range(4)]
        steps = list(zip(self.orders, keys))
        if inverse:
            for order, key in reversed(steps):
                x = _flip(masked_conv(_flip(x, order), masked_kernel(p[key]),
                                      self.control), order)
            return x
        for order, key in steps:
            x = _flip(solve_tl(_flip(x, order), masked_kernel(p[key]),
                               self.control), order)
        return x

    def _activation(self, p, x, inverse=False):
        if self.model["activation"] == "SLR":
            if inverse:
                raise NotImplementedError("SLR inverse")
            a = SLR_ALPHA
            y = a * x + (1 - a) * torch.logaddexp(x, torch.zeros_like(x))
            lad = torch.log(torch.abs(a + (1 - a) * torch.sigmoid(x)))
            return y, lad.reshape(x.shape[0], -1).sum(-1)
        y, lad = rq_spline(x, p["widths"], p["heights"], p["derivs"],
                           self.model["tail_bound"], inverse)
        return y, lad.reshape(x.shape[0], -1).sum(-1)

    def _step(self, ps, x, init=False):
        """One step (ActNorm, solve, activation, coupling); ``init``
        first sets ActNorm from x's statistics."""
        an, sv, act, cp = ps if len(ps) == 4 else (ps[0], ps[1], None, ps[2])
        if init:
            std, mean = torch.std_mean(x, dim=(0, 2, 3), correction=0)
            an["translation"].copy_(mean)
            an["log_scale"].copy_(torch.log(std + 1e-8))
        ldj = (-an["log_scale"].sum() * x.shape[2] * x.shape[3]).expand(
            x.shape[0])
        x = (x - an["translation"].reshape(1, -1, 1, 1)) * \
            torch.exp(-an["log_scale"].reshape(1, -1, 1, 1))
        x = self._solve(sv, x)
        x, l = self._activation(act, x)
        ldj = ldj + l
        x, l = self._coupling(cp, x)
        return x, ldj + l

    def _step_inverse(self, ps, z):
        an, sv, act, cp = ps if len(ps) == 4 else (ps[0], ps[1], None, ps[2])
        z, _ = self._coupling(cp, z, inverse=True)
        z, _ = self._activation(act, z, inverse=True)
        z = self._solve(sv, z, inverse=True)
        return z * torch.exp(an["log_scale"].reshape(1, -1, 1, 1)) + \
            an["translation"].reshape(1, -1, 1, 1)

    def _split_params(self, i):
        head = f"layers.{i}."
        return {k[len(head):]: v for k, v in self.w.items()
                if k.startswith(head)}

    # -- the model ----------------------------------------------------------
    def forward(self, x, noise, init=False):
        """log p(x) of raw 0-255 images ``x`` under dequantization noise
        ``noise`` (B,); ``init``: ActNorm's data init on the way (no
        gradient)."""
        alpha = self.model["alpha"]
        b = x.shape[0]
        logdet = torch.zeros(b, device=x.device)
        d = int(np.prod(x.shape[1:]))
        x = x + noise
        x = x / 256.0
        logdet = logdet + float(-d * np.log(np.float32(256.0)))
        scale = 1.0 / (1.0 - 2.0 * alpha)
        x = (x + alpha) / scale
        logdet = logdet + float(-d * np.log(np.float32(scale)))
        lx, l1x = torch.log(x), torch.log1p(-x)
        logdet = logdet + (-lx - l1x).reshape(b, -1).sum(-1)
        x = lx - l1x
        for i, kind, size in self.plan[4:]:
            if kind == "squeeze":
                x = squeeze(x)
            elif kind == "block":
                block = torch.zeros(b, device=x.device)
                for k in range(self.model["block_size"]):
                    x, l = self._step(self._step_params(i, k), x, init)
                    block = block + l
                logdet = logdet + block
            else:
                x, l = self._coupling(self._split_params(i), x)
                half = x.shape[1] // 2
                zf = x[:, half:].reshape(b, -1)
                logdet = logdet + (-0.5 * (zf * zf + LOG_2PI).sum(-1) + l)
                x = x[:, :half]
        zf = x.reshape(b, -1)
        return -0.5 * (zf * zf + LOG_2PI).sum(-1) + logdet

    def inverse(self, z, halves):
        """Images from the prior's ``z`` and each SplitPrior's factored-out
        half (``halves``: layer index -> tensor)."""
        alpha = self.model["alpha"]
        for i, kind, size in reversed(self.plan[4:]):
            if kind == "squeeze":
                z = unsqueeze(z)
            elif kind == "block":
                for k in reversed(range(self.model["block_size"])):
                    z = self._step_inverse(self._step_params(i, k), z)
            else:
                z, _ = self._coupling(self._split_params(i),
                                      torch.cat([z, halves[i]], 1),
                                      inverse=True)
        z = torch.sigmoid(z)
        z = z * (1.0 / (1.0 - 2.0 * alpha)) + (-alpha)
        return torch.floor(z * 256.0)

    @torch.no_grad()
    def data_init(self, x, noise):
        self.forward(x, noise, init=True)

    # -- training -----------------------------------------------------------
    def loss_and_grads(self, x, noise, rows):
        """Mean of the NaN-scrubbed -log p(x) and its gradient, the batch
        taken ``rows`` images at a time. Returns (loss, {name: grad})."""
        b = x.shape[0]
        leaves = {k: v.detach().requires_grad_(True) for k, v in self.w.items()}
        saved, self.w = self.w, leaves
        total = torch.zeros((), dtype=torch.float64, device=x.device)
        try:
            for s in range(0, b, rows):
                nll = -self.forward(x[s:s + rows], noise[s:s + rows])
                nll = torch.where(torch.isnan(nll), 0.0, nll)
                part = nll.sum() / b
                part.backward()
                total += part.detach().double()
        finally:
            self.w = saved
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                 for k, v in leaves.items()}
        return float(total), grads

    @torch.no_grad()
    def adam_step(self, grads, lr, clamp=None, b1=0.9, b2=0.999, eps=1e-8):
        """Adam (bias-corrected, as Kingma and Ba), then the optional
        clamp of every weight to +-clamp."""
        for k, g in grads.items():
            m, v, t = self.adam.get(k, (torch.zeros_like(g),
                                        torch.zeros_like(g), 0))
            t += 1
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            self.adam[k] = (m, v, t)
            denom = (v / (1 - b2 ** t)).sqrt() + eps
            self.w[k] -= (lr / (1 - b1 ** t)) * m / denom
            if clamp:
                self.w[k].clamp_(-clamp, clamp)


def lr_at(experiment, steps_per_epoch, step):
    """Learning rate of optimizer step ``step`` (from 0): linear warmup
    over ``warmup_epochs`` epochs times the epoch's schedule factor."""
    warm = max(1, experiment["warmup_epochs"] * steps_per_epoch)
    factor = min((step + 1.0) / warm, 1.0)
    name = experiment.get("scheduler_name", "None")
    epoch = step // steps_per_epoch
    if name == "ExponentialLR":
        factor *= experiment["gamma"] ** epoch
    elif name not in ("None", None):
        raise ValueError(f"scheduler {name!r} not in the reference")
    return experiment["lr"] * factor
