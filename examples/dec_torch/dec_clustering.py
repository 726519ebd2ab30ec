"""Deep Embedded Clustering (DEC) with a NumpyOp KL-refinement loss.

TPU-native counterpart of the reference's example/dec/dec.py (Xie et al.
2016: pretrain an autoencoder, take its encoder as the embedding, soft-
assign points to cluster centroids with a Student's-t kernel, and
refine encoder + centroids by KL(P||Q) against a sharpened target
distribution — the reference wires the loss in as a python operator;
here the same DECLoss is a `mx.operator.NumpyOp`, the identical
extension mechanism).

Pipeline: synthetic Gaussian blobs through a fixed nonlinear lift ->
autoencoder pretrain -> k-means centroid init in embedding space -> DEC
refinement. Success = unsupervised cluster accuracy (best 1:1 label map)
above 0.9 after refinement.

examples/dec/dec_clustering.py on mxnet_tpu_torch: its imports
rewritten and ``--ctx`` taking ``gpu`` (the default: ``gpu(0)``, no
fallback to the CPU) or ``cpu``, the context every executor binds to and
the current one for the run. The DECLoss NumpyOp runs on the host
between the card's ops.

Run: python3 examples/dec_torch/dec_clustering.py [--ctx cpu]
"""
import argparse
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import symbol as sym  # noqa: E402


class DECLoss(mx.operator.NumpyOp):
    """Student's-t soft assignment + KL(P||Q) gradients (ref dec.py's
    python operator; Xie et al. eqs. 1-3).

    forward: q_ij = (1+|z_i-mu_j|^2)^-1 normalized over j.
    backward: dL/dz and dL/dmu for L = KL(P||Q), with the target
    P computed from Q and held constant (set via set_target)."""

    def __init__(self):
        super().__init__(need_top_grad=False)
        self.p = None

    def list_arguments(self):
        return ["z", "mu"]

    def list_outputs(self):
        return ["q"]

    def infer_shape(self, in_shape):
        zs, ms = in_shape
        return [zs, ms], [(zs[0], ms[0])]

    @staticmethod
    def soft_assign(z, mu):
        d2 = ((z[:, None, :] - mu[None, :, :]) ** 2).sum(-1)
        q = 1.0 / (1.0 + d2)
        return q / q.sum(1, keepdims=True)

    @staticmethod
    def target(q):
        w = q ** 2 / q.sum(0, keepdims=True)
        return w / w.sum(1, keepdims=True)

    def set_target(self, p):
        self.p = p

    def forward(self, in_data, out_data):
        z, mu = in_data
        out_data[0][:] = self.soft_assign(z, mu)

    def backward(self, out_grad, in_data, out_data, in_grad):
        z, mu = in_data
        q = out_data[0]
        p = self.p if self.p is not None else self.target(q)
        d2 = ((z[:, None, :] - mu[None, :, :]) ** 2).sum(-1)
        # dKL/dz_i = 2 sum_j (p-q)_ij (1+d2)^-1 (z_i - mu_j)  (eq. 4/5);
        # descent then moves z_i toward centroids it under-assigns to
        w = (p - q) / (1.0 + d2)
        diff = z[:, None, :] - mu[None, :, :]
        in_grad[0][:] = 2.0 * (w[:, :, None] * diff).sum(1)
        in_grad[1][:] = -2.0 * (w[:, :, None] * diff).sum(0)


def make_blobs(n_per, k, dim, rng):
    centers = rng.randn(k, 4) * 3.0
    lift = rng.randn(4, dim).astype("f")
    xs, ys = [], []
    for c in range(k):
        pts = centers[c] + rng.randn(n_per, 4) * 0.4
        xs.append(np.tanh(pts @ lift))
        ys.append(np.full(n_per, c))
    x = np.concatenate(xs).astype("f")
    y = np.concatenate(ys)
    order = rng.permutation(len(y))
    return x[order], y[order]


def kmeans(z, k, rng, iters=20):
    mu = z[rng.choice(len(z), k, replace=False)].copy()
    for _ in range(iters):
        a = ((z[:, None] - mu[None]) ** 2).sum(-1).argmin(1)
        for j in range(k):
            if (a == j).any():
                mu[j] = z[a == j].mean(0)
    return mu


def cluster_accuracy(assign, labels, k):
    """Best one-to-one map via greedy confusion maximization."""
    conf = np.zeros((k, k))
    for a, l in zip(assign, labels):
        conf[int(a), int(l)] += 1
    total, used = 0, set()
    for a in np.argsort(-conf.max(1)):
        l = int(np.argmax([conf[a, j] if j not in used else -1
                           for j in range(k)]))
        used.add(l)
        total += conf[a, l]
    return total / len(labels)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--embed", type=int, default=5)
    ap.add_argument("--pretrain-steps", type=int, default=300)
    ap.add_argument("--refine-epochs", type=int, default=15)
    ap.add_argument("--ctx", type=str, default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args()
    ctx = mx.cpu() if args.ctx == "cpu" else mx.gpu()
    with ctx:   # the example's arrays are made on the current context
        _run(args, ctx)


def _run(args, ctx):

    rng = np.random.RandomState(0)
    mx.random.seed(0)
    K, D, E = args.clusters, 20, args.embed
    x, y = make_blobs(100, K, D, rng)
    N = len(x)

    # -- autoencoder pretrain ------------------------------------------------
    data = sym.Variable("data")
    enc = sym.Activation(sym.FullyConnected(data, num_hidden=32, name="enc1"),
                         act_type="relu")
    z_sym = sym.FullyConnected(enc, num_hidden=E, name="enc2")
    dec = sym.Activation(sym.FullyConnected(z_sym, num_hidden=32, name="dec1"),
                         act_type="relu")
    recon = sym.FullyConnected(dec, num_hidden=D, name="dec2")
    ae = sym.LinearRegressionOutput(recon, sym.Variable("label"), name="recon")
    init = mx.initializer.Xavier()
    arg_shapes, _, _ = ae.infer_shape(data=(N, D), label=(N, D))
    aa, ag = {}, {}
    for n, s in zip(ae.list_arguments(), arg_shapes):
        arr = mx.nd.zeros(s)
        if n not in ("data", "label"):
            init(n, arr)
            ag[n] = mx.nd.zeros(s)
        aa[n] = arr
    exe = ae.bind(ctx, aa, args_grad=ag,
                  grad_req={n: ("write" if n in ag else "null") for n in aa})
    opt = mx.optimizer.Adam(learning_rate=3e-3)
    st = {n: opt.create_state(i, aa[n]) for i, n in enumerate(ag)}
    aa["data"][:] = x
    aa["label"][:] = x
    for _ in range(args.pretrain_steps):
        exe.forward(is_train=True)
        exe.backward()
        for i, n in enumerate(ag):
            opt.update(i, aa[n], ag[n], st[n])

    # -- DEC refinement ------------------------------------------------------
    loss_op = DECLoss()
    mu_var = sym.Variable("mu")
    net = loss_op(z=z_sym, mu=mu_var, name="dec")
    enc_params = {n: aa[n] for n in ("enc1_weight", "enc1_bias",
                                     "enc2_weight", "enc2_bias")}
    # init centroids by k-means on the pretrained embedding
    zexe = z_sym.bind(ctx, {"data": mx.nd.array(x), **enc_params},
                      grad_req="null")
    z0 = zexe.forward()[0].asnumpy()
    mu0 = kmeans(z0, K, rng)
    acc_init = cluster_accuracy(
        ((z0[:, None] - mu0[None]) ** 2).sum(-1).argmin(1), y, K)

    dargs = {"data": mx.nd.array(x), "mu": mx.nd.array(mu0), **enc_params}
    dgrads = {n: mx.nd.zeros(dargs[n].shape) for n in
              list(enc_params) + ["mu"]}
    dexe = net.bind(ctx, dargs, args_grad=dgrads,
                    grad_req={n: ("write" if n in dgrads else "null")
                              for n in dargs})
    dopt = mx.optimizer.Adam(learning_rate=1e-3)
    dst = {n: dopt.create_state(i, dargs[n]) for i, n in enumerate(dgrads)}
    for epoch in range(args.refine_epochs):
        # infer-only read of q to refresh the target (no backward cost)
        q = dexe.forward(is_train=False)[0].asnumpy()
        loss_op.set_target(DECLoss.target(q))  # sharpen, then hold fixed
        for _ in range(20):
            dexe.forward(is_train=True)
            dexe.backward()
            for i, n in enumerate(dgrads):
                dopt.update(i, dargs[n], dgrads[n], dst[n])
    q = dexe.forward(is_train=False)[0].asnumpy()
    acc = cluster_accuracy(q.argmax(1), y, K)
    print("cluster accuracy: k-means init %.3f -> DEC %.3f" % (acc_init, acc))
    if not os.environ.get("MXNET_EXAMPLE_SMOKE"):
        assert acc > 0.9, "DEC failed to cluster (%.3f)" % acc
        assert acc >= acc_init - 1e-9, "DEC refinement degraded the init"
    print("ok")


if __name__ == "__main__":
    main()
