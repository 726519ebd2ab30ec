"""Model definitions of the port: the transformer LM (a parameter
dict and functions) and the Symbol graphs LeNet and ResNet."""
from __future__ import annotations

from . import transformer
from .lenet import get_lenet
from .resnet import get_resnet, get_resnet_small

__all__ = ["transformer", "get_lenet", "get_resnet", "get_resnet_small"]
