"""Model definitions of the port: the transformer LM (a parameter
dict and functions) and the Symbol graphs of the JAX package's model
zoo: LeNet, the MLP, ResNet, Inception-BN (the 224x224 net and the
28x28 small one), AlexNet, VGG, GoogLeNet, Inception-v3, U-Net and the
unrolled recurrent language models (LSTM, GRU, Elman RNN)."""
from __future__ import annotations

from . import transformer
from .lenet import get_lenet
from .mlp import get_mlp
from .resnet import get_resnet, get_resnet_small
from .inception_bn import get_inception_bn, get_inception_bn_small
from .classic_convnets import (
    get_alexnet, get_vgg, get_googlenet, get_inception_v3,
)
from .unet import get_unet
from .lstm import lstm_unroll
from .gru import gru_unroll
from .rnn import rnn_unroll

__all__ = [
    "get_lenet", "get_mlp", "get_resnet", "get_resnet_small",
    "get_inception_bn", "get_inception_bn_small",
    "get_alexnet", "get_vgg", "get_googlenet", "get_inception_v3",
    "get_unet",
    "lstm_unroll", "gru_unroll", "rnn_unroll", "transformer",
]
