"""Model definitions of the port: the transformer LM (a parameter
dict and functions) and the Symbol graphs LeNet, ResNet and the
unrolled recurrent language models (LSTM, GRU, Elman RNN)."""
from __future__ import annotations

from . import transformer
from .lenet import get_lenet
from .resnet import get_resnet, get_resnet_small
from .lstm import lstm_unroll
from .gru import gru_unroll
from .rnn import rnn_unroll

__all__ = ["transformer", "get_lenet", "get_resnet", "get_resnet_small",
           "lstm_unroll", "gru_unroll", "rnn_unroll"]
