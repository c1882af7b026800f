"""Shape-aware resolution of ``solver='auto'``: where the exact chain
solve and the Jacobi solve cross over on the H100.

Port of ``inverse_flow_tpu/ops/solver_policy.py`` (``resolve_auto``,
``auto_jacobi_params``), with the same logic: the tall-thin window, the
per-group channels, the kernel-size gate, the nilpotency cap and the tol
clamp. The constants are the card's own, set from ``chip_smoke.py``
phase 13, which times the Fig. 4 sweeps of
``experiments/timescaling.py`` (batch 128, 2 layers of ``InvFlowNoPad(1,
(2, 2))``, ``ms_best`` of 4 trials of 20 chained loss-and-backward
steps) on both arms:

* ``'exact'``: the chain solve (``ops/fused_chain.py``); its sequential
  depth grows with the number of row blocks, and its operator build,
  plain torch on the host's queue, grows with the rows of a block;
* ``'jacobi'``: :func:`~inverse_flow_tpu_torch.ops.inv_conv.inv_conv_solve_jacobi_implicit`,
  12 masked convs a solve whatever the height.

Measured by ``python3 chip_smoke.py`` phase 13 on an NVIDIA H100 80GB
HBM3 at a 700.00 W power limit (float32, TF32 off), ms a step:

    shape (1, H, 1)   exact ms   jacobi ms   winner
    H = 32              14.436      5.458    jacobi
    H = 128             38.326      5.996    jacobi
    H = 512            106.955      6.085    jacobi
    H = 2048           224.726      5.264    jacobi
    H = 4160           207.661      6.537    jacobi

    shape (1, s, s)   exact ms   jacobi ms
    s = 8               11.244      4.502
    s = 16              15.121      5.280
    s = 32              17.629      6.056
    s = 64              13.415      5.765
    s = 128             12.120      4.508

(An earlier run of the phase on the same card gave the same verdict at
every size.) Jacobi beats the exact arm at every measured tall size, so
the window is H in [32, 4160]: shorter and taller images were not
measured and stay exact. Squares stay exact although Jacobi was faster
there too: a square's nilpotency cap (``auto_jacobi_params``) is H*W
iterations (16,384 at s = 128) where a tall image's is H, so a guard
fallback on a square would cost thousands of convs; the thin gate keeps
the JAX policy's shape. Both arms are host-bound on the card (the exact
arm's operator build: 12,817 launch calls a step at H = 4160, the device
busy 19.4 of 353.2 ms under the profiler; the Jacobi arm's 293 launch
calls, busy 0.9 of 11.9 ms), so this window is a statement about today's
host path: re-measure it after each host cut of the operator build
(ROADMAP 1.3).

The tolerances. The step difference of a converged iteration, over 16
iterations past 184, never exceeded 1.648e-7 of ``1 + max|x|`` (tall
images at the init plus N(0, 0.05) and at every tap 0.7; a square at the
init): the float32 floor. A bare 12-term solve at every tap 0.7 errs by
8.832e-3 of ``1 + max|x|`` (one layer at (128, 1, 32, 1)), the error the
guard exists to catch. ``JACOBI_AUTO_TOL`` = 1e-4 sits 607x above the
floor and 88x below that error (1e-3 would sit only 8.8x below it, and
accept residuals whose forward error exceeds the 1e-4 at which
``'auto'`` is held to ``'exact'``); ``JACOBI_TOL_MIN`` = 2e-6, 12x the
floor, is the smallest user tol the guard can still meet.
"""

from __future__ import annotations

# the measured tall sizes: Jacobi won at each of them
JACOBI_LONG_MIN = 32
JACOBI_LONG_MAX = 4160
# short axis x per-group channels: the sweeps measure 1 only
JACOBI_THIN_MAX = 1
# every row was measured at a 2x2 kernel
JACOBI_KERNEL_MAX = 2
# the guard's threshold, relative to 1 + max|x| (see above)
JACOBI_AUTO_TOL = 1e-4
# the smallest user jacobi_tol the policy honors as given
JACOBI_TOL_MIN = 2e-6


def resolve_auto(x_shape, kernel_size=(3, 3), groups: int = 1) -> str:
    """``'jacobi'`` for an activation shape ``(B, C, H, W)`` (or ``(C, H,
    W)``) inside the measured tall-thin window, ``'exact'`` everywhere
    else. A wide ``(1, 1, W)`` image is not the transpose of a tall one
    for the exact solve (its blocks run over rows: H = 1 is one block), so
    H must be the long axis."""
    c, h, w = (int(x_shape[-3]), int(x_shape[-2]), int(x_shape[-1]))
    cg = c // max(groups, 1)
    if (h >= w
            and w * cg <= JACOBI_THIN_MAX
            and JACOBI_LONG_MIN <= h <= JACOBI_LONG_MAX
            and max(kernel_size) <= JACOBI_KERNEL_MAX):
        return "jacobi"
    return "exact"


def auto_jacobi_params(x_shape, groups: int = 1, requested_iters: int = 12,
                       requested_tol: float = 0.0):
    """``(fast_iters, cap_iters, tol)`` of a policy-routed Jacobi solve
    (:func:`~inverse_flow_tpu_torch.ops.inv_conv.inv_conv_solve_jacobi_guarded_implicit`):

    * ``fast_iters``: the layer's ``jacobi_iters``;
    * ``cap_iters``: ``cg*H*W``, the nilpotency index of the strictly
      triangular part, where the series is exact for any weights (at
      least ``requested_iters``);
    * ``tol``: the layer's ``jacobi_tol`` when at least
      ``JACOBI_TOL_MIN`` (a threshold the guard can meet above the
      float32 floor), else ``JACOBI_AUTO_TOL``.
    """
    c, h, w = (int(x_shape[-3]), int(x_shape[-2]), int(x_shape[-1]))
    cg = c // max(groups, 1)
    nilpotency_cap = max(cg * h * w, requested_iters)
    tol = (requested_tol if requested_tol >= JACOBI_TOL_MIN
           else JACOBI_AUTO_TOL)
    return requested_iters, nilpotency_cap, tol
