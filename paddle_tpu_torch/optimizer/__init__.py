"""Optimizers of the port (mirror of ``paddle_tpu/optimizer``)."""

from . import lr
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grads_functional)
from .optimizer import (
    ASGD, LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
    LarsMomentum, Momentum, NAdam, Optimizer, RAdam, RMSProp, Rprop,
)

__all__ = ["ASGD", "Adadelta", "Adagrad", "Adam", "Adamax", "AdamW",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "LBFGS", "Lamb", "LarsMomentum", "Momentum", "NAdam", "Optimizer",
           "RAdam", "RMSProp", "Rprop", "SGD", "clip_grads_functional", "lr"]
