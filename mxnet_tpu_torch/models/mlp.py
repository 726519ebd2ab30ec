"""2-hidden-layer MLP — the canonical shared test fixture
(ref: tests/python/common/models.py mlp2, train_mnist.py get_mlp)."""
from __future__ import annotations

from .. import symbol as sym


def get_mlp(num_classes=10):
    data = sym.Variable("data")
    fc1 = sym.FullyConnected(data=data, name="fc1", num_hidden=128)
    act1 = sym.Activation(data=fc1, name="relu1", act_type="relu")
    fc2 = sym.FullyConnected(data=act1, name="fc2", num_hidden=64)
    act2 = sym.Activation(data=fc2, name="relu2", act_type="relu")
    fc3 = sym.FullyConnected(data=act2, name="fc3", num_hidden=num_classes)
    mlp = sym.SoftmaxOutput(data=fc3, name="softmax")
    return mlp
