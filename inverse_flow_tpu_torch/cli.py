"""Command-line entry point: ``python -m inverse_flow_tpu_torch.cli --name
<exp>`` (or ``ift-torch``).

The JAX CLI's flags and semantics (``inverse_flow_tpu/cli.py``) for the
experiments the port builds: ``--list``, ``--name``, ``--smoke`` (a
miniature model of the experiment's family on synthetic data, 2 epochs),
``--epochs``, ``--batch-size``, ``--profile-dir`` (a ``torch.profiler``
trace of epoch 1) and ``--resume``. The run is on the CUDA card, and
raises without one, unless ``--cpu`` is given. The summary is printed as
JSON on the last line. ``memory_speed`` and the ``*timescaling`` sweeps
run their own configuration (``--smoke``: the small one) and ignore the
other flags, as in JAX; their records go to ``./memory_speed.jsonl`` and
``./<name>_timescale.jsonl``.

The data-parallel configurations (``if_multiGPU_imagenet32``,
``if_imagenet_multi_gpu``) run one process a card under ``torchrun``::

    torchrun --standalone --nproc_per_node=N -m inverse_flow_tpu_torch.cli \
        --name if_multiGPU_imagenet32

Each process joins the group that ``torchrun`` describes and trains on
``cuda:<LOCAL_RANK>`` (gloo on the CPU with ``--cpu``); rank 0 prints the
summary. Without ``torchrun`` they train on one card.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    parser = argparse.ArgumentParser("inverse_flow_tpu_torch")
    parser.add_argument("--name", type=str, required=False,
                        help="experiment name (see --list)")
    parser.add_argument("--list", action="store_true")
    parser.add_argument("--smoke", action="store_true",
                        help="tiny config + synthetic data, 2 epochs")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the CUDA card")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace of epoch 1")
    parser.add_argument("--resume", nargs="?", const="", default=None,
                        metavar="CKPT",
                        help="resume from a checkpoint (default: the "
                             "experiment's own checkpoint path)")
    args = parser.parse_args(argv)

    from .experiments import EXPERIMENTS

    if args.list or not args.name:
        print("available experiments:")
        for name in sorted(set(EXPERIMENTS) | {"memory_speed"}):
            print(f"  {name}")
        return 0

    import torch.distributed as dist

    from .parallel import init_from_env
    owns_group = not dist.is_initialized()
    device = init_from_env(cpu=args.cpu)
    try:
        return _run(args, device)
    finally:
        # a group this process joined from torchrun's environment
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, device):
    """The experiment ``args.name`` on ``device`` (its sweep, or
    ``Experiment.run()`` of its registry entry); rank 0 prints the
    summary."""
    import torch

    from .experiments import get_experiment
    from .parallel import world

    def _warn_ignored(kind):
        ignored = [f for f, v in (("--epochs", args.epochs),
                                  ("--batch-size", args.batch_size),
                                  ("--profile-dir", args.profile_dir),
                                  ("--resume", args.resume)) if v is not None]
        if ignored:
            print(f"warning: {kind} runs its own sweep config; "
                  f"ignoring {', '.join(ignored)}", file=sys.stderr)

    if args.name == "memory_speed":
        from .experiments.memory_speed import run_memory_speed
        _warn_ignored("memory_speed")
        return run_memory_speed(smoke=args.smoke, device=device)

    spec = get_experiment(args.name)
    cfg = spec.config

    if args.name.endswith("timescaling"):
        from .experiments.timescaling import run_timescaling
        _warn_ignored("timescaling")
        return run_timescaling(args.name, smoke=args.smoke, device=device)

    overrides = {}
    if args.profile_dir:
        overrides["profile_dir"] = args.profile_dir
    if args.smoke:
        overrides.update(epochs=2, batch_size=16, n_samples=4,
                         log_interval=5, sample_epochs=1, eval_epochs=1,
                         save_images=False)
    # explicit flags beat smoke defaults
    if args.epochs is not None:
        overrides["epochs"] = args.epochs
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size
    cfg = cfg.replace(**overrides)

    generator = torch.Generator(device).manual_seed(cfg.seed)
    if args.smoke:
        flow = _smoke_model(spec, device, generator)
        from .data import synthetic
        loaders = synthetic.load_data(_smoke_data_size(spec), n_train=64,
                                      n_val=32, n_test=32,
                                      batch_size=cfg.batch_size)
    else:
        flow = spec.build_model(device=device, generator=generator)
        loaders = spec.load_data(batch_size=cfg.batch_size)

    from .train.experiment import Experiment
    exp = Experiment(flow, *loaders, cfg, device=device)
    if args.resume is not None:
        exp.load(args.resume or None)
    summary = exp.run()
    if world().rank == 0:
        print(json.dumps({k: _j(v) for k, v in summary.items()}))
    return 0


def _smoke_data_size(spec):
    return (3, 8, 8) if "cifar" in spec.name or "imagenet" in spec.name \
        else (1, 8, 8)


def _smoke_model(spec, device, generator):
    """A miniature model of the same family as the experiment, by the JAX
    CLI's rule: the step kind from the name (SelfNorm, Conv1x1, FincFlow,
    Emerging, ConvExp, else ``inv_conv_no_pad``), an FC or CNN stack for the
    ``fc`` and ``cnn`` names, else a Glow."""
    from .models.glow import build_cnn_flow, build_fc_flow, build_glow
    name = spec.name
    size = _smoke_data_size(spec)
    init = dict(generator=generator, device=device)
    kind_map = {"snf": "snf", "selfnorm": "snf", "conv1x1": "conv1x1",
                "ff": "ff", "emerging": "emerging", "exponential": "convexp"}
    kind = "inv_conv_no_pad"
    for key, k in kind_map.items():
        if name.startswith(key) or f"_{key}_" in name:
            kind = k
            break
    if "fc" in name.split("_"):
        return build_fc_flow(size, num_layers=2,
                             kind="snf_fc" if kind == "snf" else kind,
                             **init)
    if "cnn" in name.split("_"):
        return build_cnn_flow(size, step_kind="snf_cnn" if kind == "snf"
                              else kind, num_blocks=2, block_size=2, **init)
    return build_glow(size, step_kind=kind, num_blocks=2, block_size=2,
                      coupling_width=16, **init)


def _j(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


if __name__ == "__main__":
    sys.exit(main())
