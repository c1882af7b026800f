from .base import FlowLayer, sum_except_batch, zeros_ldj
from .sequential import Flow
from .preprocess import (Dequantization, Normalization, LogitTransform,
                         SigmoidTransform)
from .actnorm import ActNorm, ActNormFC, ActNormPlainLayer
from .squeeze import Squeeze, UnSqueeze
from .conv1x1 import Conv1x1, Conv1x1Householder
from .coupling import Coupling, BSplineCoupling
from .splitprior import SplitPrior, SplitPriorFC
from .activations import (FlowActivationLayer, SmoothLeakyRelu, LeakyRelu,
                          LearnableLeakyRelu, SmoothTanh, SplineActivation,
                          BSplineActivation, Identity)
from .splines import ConditionalBSplineTransformer
from .inv_flow import InvFlow, InvFlowNoPad, InvFlowUnit
from .padded_conv import FincFlowUnit, PaddedConv2d
from .repeated import RepeatedBlock
from .selfnorm import SelfNormConv, SelfNormFC
from .emerging import Emerging, Flip2d, SquareAutoRegressiveConv2d
from .convexp import ConvExp
from .gaussianize import Gaussianize, GaussianizeSplit

__all__ = [
    "FlowLayer", "Flow", "sum_except_batch", "zeros_ldj",
    "Dequantization", "Normalization", "LogitTransform", "SigmoidTransform",
    "ActNorm", "ActNormFC", "ActNormPlainLayer", "Squeeze", "UnSqueeze",
    "Conv1x1", "Conv1x1Householder", "Coupling", "BSplineCoupling",
    "SplitPrior", "SplitPriorFC",
    "FlowActivationLayer", "SmoothLeakyRelu", "LeakyRelu",
    "LearnableLeakyRelu", "SmoothTanh", "SplineActivation",
    "BSplineActivation", "ConditionalBSplineTransformer", "Identity",
    "InvFlow", "InvFlowNoPad", "InvFlowUnit", "PaddedConv2d",
    "FincFlowUnit", "SelfNormConv", "SelfNormFC", "Emerging",
    "SquareAutoRegressiveConv2d", "Flip2d", "ConvExp", "RepeatedBlock",
    "Gaussianize", "GaussianizeSplit",
]
