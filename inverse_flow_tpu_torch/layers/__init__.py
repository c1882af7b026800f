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
from .selfnorm import SelfNormConv, SelfNormFC
from .conv1x1 import Conv1x1, Conv1x1Householder
from .emerging import Emerging, Flip2d, SquareAutoRegressiveConv2d

__all__ = [
    "FlowLayer", "Flow", "sum_except_batch", "zeros_ldj",
    "Dequantization", "Normalization", "LogitTransform", "ActNorm",
    "Squeeze", "Coupling", "SplitPrior", "SmoothLeakyRelu",
    "SplineActivation", "InvFlow", "InvFlowNoPad", "InvFlowUnit",
    "PaddedConv2d", "FincFlowUnit", "RepeatedBlock", "SelfNormConv",
    "SelfNormFC", "Conv1x1", "Conv1x1Householder", "Emerging", "Flip2d",
    "SquareAutoRegressiveConv2d",
]
