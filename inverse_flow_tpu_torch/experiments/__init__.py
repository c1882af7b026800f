from .registry import EXPERIMENTS, ExperimentSpec, get_experiment

__all__ = ["EXPERIMENTS", "ExperimentSpec", "get_experiment"]
