"""The comparisons that decide ``correct``.

Train steps: each checked step's loss as a relative gap; the first
step's gradient and the parameters' change over the checked steps by
their worst leaf: the gap between the program's norm of the leaf and the
reference's, over the larger of the reference's norm of that leaf and of
the median leaf. Leaves whose reference gradient stays under a
thousandth of the median leaf's on every checked step move by round-off
alone under Adam, and are left out of the change.

Samples: each image against the reference's from the same noise; an
image's reading is the share of its pixels whose 0-255 level differs, and
the number compared is the worst image's.
"""

from __future__ import annotations

import statistics

QUIET = 1e-3


def leaf_norms(tensors):
    """{name: float64 2-norm}."""
    import torch

    names = list(tensors)
    vals = torch.stack([tensors[n].detach().double().norm() for n in names])
    return dict(zip(names, vals.tolist()))


def worst_leaf_gap(prog, ref, leaves=None):
    """max over ``leaves`` (all by default) of |prog - ref| / max(ref,
    median(ref)); ``prog`` and ``ref`` map names to norms."""
    names = list(ref) if leaves is None else list(leaves)
    if not names:
        return 0.0
    floor = statistics.median(ref.values())
    gaps = [abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], floor, 1e-30)
            for n in names]
    return max(gaps)


def loud_leaves(grad_norms_by_step):
    """Leaves whose reference gradient reaches a thousandth of the median
    leaf's on some checked step."""
    out = set()
    for norms in grad_norms_by_step:
        floor = statistics.median(norms.values())
        out |= {n for n, v in norms.items() if v >= QUIET * floor}
    return out


def loss_gap(prog, ref):
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def worst_image_share(prog, ref):
    """The largest share of one image's pixels whose level differs; 1.0
    where the shapes differ or a value is not finite."""
    import torch

    if prog.shape != ref.shape:
        return 1.0
    off = (prog != ref) | ~torch.isfinite(prog)
    return float(off.reshape(off.shape[0], -1).float().mean(1).max())
