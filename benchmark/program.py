"""The benchmark's side of the program: the port built through its normal
entry points, on the benchmark's weights.

``build_glow`` builds the structure on the meta device (no leaf-by-leaf
draws), the module is materialised on the card, and the weights that the
benchmark drew from the seed (:func:`benchmark.reference.glow.make_weights`)
are loaded under their names; a name or shape that differs raises.
"""

from __future__ import annotations


def build_flow(cell, weights):
    """The program's ``Flow`` of ``cell``'s configuration, holding
    ``weights``."""
    from inverse_flow_tpu_torch.models.glow import build_glow

    cfg = cell.config
    flow = build_glow(tuple(cfg["data_shape"]), device="meta", **cfg["model"])
    if list(flow.buffers()):
        raise RuntimeError("the flow holds buffers, which the benchmark's "
                           "weights do not fill")
    flow = flow.to_empty(device=cell.device)
    flow.load_state_dict(weights, strict=True)
    return flow


class Feed:
    """The train loader an ``Experiment`` is given: the batch size, the
    image shape and the epoch length in batches (the schedule's unit).
    The benchmark feeds ``train_step`` itself."""

    def __init__(self, batch, data_shape, steps_per_epoch):
        self.batch_size = batch
        self.data_shape = tuple(data_shape)
        self._len = steps_per_epoch

    def __len__(self):
        return self._len

    def __iter__(self):
        return iter(())


def steps_per_epoch(cell):
    """The epoch in steps: one pass over the traffic's distinct batches."""
    return int(cell.traffic["pool_batches"])


def experiment(cell, flow, seed):
    """The program's ``Experiment`` around ``flow`` with the
    configuration's optimizer settings; its dequantization noise is drawn
    from ``seed``. It logs, samples and saves nothing."""
    from inverse_flow_tpu_torch.train.config import ExperimentConfig
    from inverse_flow_tpu_torch.train.experiment import Experiment

    cfg = ExperimentConfig(name=cell.name, seed=seed, save_images=False,
                           log_timing=False, plot_recon=False,
                           batch_size=cell.traffic["batch"],
                           **cell.config["experiment"])
    feed = Feed(cell.traffic["batch"], cell.config["data_shape"],
                steps_per_epoch(cell))
    return Experiment(flow, feed, None, None, cfg, device=cell.device)
