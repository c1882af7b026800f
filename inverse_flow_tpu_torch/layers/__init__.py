from .base import FlowLayer, sum_except_batch, zeros_ldj
from .sequential import Flow
from .preprocess import Dequantization, Normalization, LogitTransform
from .actnorm import ActNorm
from .squeeze import Squeeze
from .coupling import Coupling
from .splitprior import SplitPrior
from .activations import SmoothLeakyRelu, SplineActivation
from .inv_flow import InvFlow, InvFlowNoPad, InvFlowUnit
from .padded_conv import FincFlowUnit, PaddedConv2d
from .repeated import RepeatedBlock

__all__ = [
    "FlowLayer", "Flow", "sum_except_batch", "zeros_ldj",
    "Dequantization", "Normalization", "LogitTransform", "ActNorm",
    "Squeeze", "Coupling", "SplitPrior", "SmoothLeakyRelu",
    "SplineActivation", "InvFlow", "InvFlowNoPad", "InvFlowUnit",
    "PaddedConv2d", "FincFlowUnit", "RepeatedBlock",
]
