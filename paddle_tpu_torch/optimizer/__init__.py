from . import lr
from .optimizer import Optimizer
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                         Momentum, RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adam", "AdamW",
           "Adamax", "RMSProp", "Adadelta", "Lamb", "lr"]
