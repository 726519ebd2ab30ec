"""Decoder-only transformer LM, the flagship model.

Counterpart of ``mxnet_tpu/models/transformer.py``. Params are a plain
dict of tensors in the JAX package's layout (``x @ W`` weights,
``embed [V, d]``), so a JAX params pytree carries across with
:func:`params_from_numpy` without any transpose.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..context import resolve_device

__all__ = ["TransformerConfig", "init_params", "params_from_numpy",
           "params_to_numpy", "forward", "loss_fn"]


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 4
    d_model: int = 512
    num_heads: int = 8
    d_ff: int = 2048
    max_seq_len: int = 2048
    dtype: str = "bfloat16"
    use_ring_attention: bool = False
    seq_axis: str = "seq"
    tensor_axis: str = "model"

    @property
    def head_dim(self):
        return self.d_model // self.num_heads

    @property
    def torch_dtype(self):
        return getattr(torch, self.dtype)


def init_params(cfg: TransformerConfig, generator, device=None):
    """Random params from ``generator`` (a ``torch.Generator`` on
    ``device``), with the JAX package's scales. The draws differ from
    the JAX package's threefry stream: to compare the two packages,
    build params once and carry them across with
    :func:`params_from_numpy`."""
    device = resolve_device(device)
    dtype = cfg.torch_dtype

    def dense(shape, scale=None):
        if scale is None:
            scale = 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * scale).to(dtype)

    def ln():
        return {"scale": torch.ones(cfg.d_model, device=device),
                "bias": torch.zeros(cfg.d_model, device=device)}

    params = {
        "embed": dense((cfg.vocab_size, cfg.d_model), scale=0.02),
        "pos_embed": dense((cfg.max_seq_len, cfg.d_model), scale=0.02),
        "layers": [],
        "ln_f": ln(),
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "ln1": ln(),
            "wqkv": dense((cfg.d_model, 3 * cfg.d_model)),
            "wo": dense((cfg.d_model, cfg.d_model)),
            "ln2": ln(),
            "w1": dense((cfg.d_model, cfg.d_ff)),
            "w2": dense((cfg.d_ff, cfg.d_model)),
        })
    return params


def params_from_numpy(tree, device=None, dtype=None):
    """Carry a params tree of numpy arrays (``np.asarray`` of each JAX
    leaf) across as tensors on ``device``, keeping the layout.

    Every leaf goes through f32, which is exact for f32 and bf16 leaves
    (``torch.from_numpy`` rejects ``ml_dtypes.bfloat16``). ``dtype``
    (a ``torch.dtype``) recasts the weight matrices; when None each
    leaf keeps its source dtype (bf16 leaves come back bf16). Layer-norm
    scale/bias stay f32 as in the JAX package.
    """
    device = resolve_device(device)

    def leaf(a, keep_f32=False):
        arr = np.asarray(a)
        t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
        if keep_f32:
            target = torch.float32
        elif dtype is not None:
            target = dtype
        elif arr.dtype == np.float32:
            target = torch.float32
        elif arr.dtype.name == "bfloat16":
            target = torch.bfloat16
        else:
            target = getattr(torch, arr.dtype.name)
        return t.to(device=device, dtype=target)

    def ln(p):
        return {"scale": leaf(p["scale"], True),
                "bias": leaf(p["bias"], True)}

    out = {"embed": leaf(tree["embed"]), "pos_embed": leaf(tree["pos_embed"]),
           "ln_f": ln(tree["ln_f"]), "layers": []}
    for lp in tree["layers"]:
        out["layers"].append({
            "ln1": ln(lp["ln1"]), "wqkv": leaf(lp["wqkv"]),
            "wo": leaf(lp["wo"]), "ln2": ln(lp["ln2"]),
            "w1": leaf(lp["w1"]), "w2": leaf(lp["w2"])})
    return out


def params_to_numpy(params):
    """The inverse of :func:`params_from_numpy`: a tree of f32 numpy
    arrays (bf16 leaves widen exactly), detached and on the host."""
    def leaf(t):
        return t.detach().float().cpu().numpy()

    def ln(p):
        return {"scale": leaf(p["scale"]), "bias": leaf(p["bias"])}

    return {"embed": leaf(params["embed"]),
            "pos_embed": leaf(params["pos_embed"]),
            "ln_f": ln(params["ln_f"]),
            "layers": [{"ln1": ln(lp["ln1"]), "wqkv": leaf(lp["wqkv"]),
                        "wo": leaf(lp["wo"]), "ln2": ln(lp["ln2"]),
                        "w1": leaf(lp["w1"]), "w2": leaf(lp["w2"])}
                       for lp in params["layers"]]}


def _layer_norm(x, p, eps=1e-5):
    """f32 layer norm with population variance, output in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _attention(q, k, v, causal=True):
    from ..ops.flash_attention import flash_attention

    return flash_attention(q, k, v, causal=causal)


def forward(params, tokens, cfg: TransformerConfig, mesh=None,
            attn_fn=None):
    """tokens [B, T] int -> logits [B, T, vocab] in the params' dtype.

    ``attn_fn(q, k, v)`` overrides the causal attention (default:
    :func:`~mxnet_tpu_torch.ops.flash_attention.flash_attention`, the
    kernel on CUDA tensors). ``mesh`` is accepted for signature parity;
    ring attention inside the training forward comes with the
    multi-GPU slice."""
    if cfg.use_ring_attention and mesh is not None:
        raise NotImplementedError(
            "ring attention inside forward: ROADMAP queue 1, multi-GPU "
            "mesh over NCCL")
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device).long()
    B, T = tokens.shape
    x = embed[tokens]
    x = x + params["pos_embed"][:T][None].to(x.dtype)
    if attn_fn is None:
        attn_fn = functools.partial(_attention, causal=True)

    H, D = cfg.num_heads, cfg.head_dim

    def heads(t):
        return t.reshape(B, T, H, D).transpose(1, 2)

    for lp in params["layers"]:
        h = _layer_norm(x, lp["ln1"])
        qkv = h @ lp["wqkv"]
        q, k, v = qkv.chunk(3, dim=-1)
        o = attn_fn(heads(q), heads(k), heads(v))
        o = o.transpose(1, 2).reshape(B, T, H * D)
        x = x + o @ lp["wo"]
        h = _layer_norm(x, lp["ln2"])
        x = x + _gelu(h @ lp["w1"]) @ lp["w2"]
    x = _layer_norm(x, params["ln_f"])
    return x @ embed.T


def loss_fn(cfg: TransformerConfig, mesh=None, attn_fn=None):
    """Next-token cross-entropy loss closure for
    :func:`mxnet_tpu_torch.parallel.make_train_step`; batch =
    ``dict(tokens=[B, T+1] int)``. The mean NLL of ``tokens[:, 1:]``
    under :func:`forward` of ``tokens[:, :-1]``, log-softmax in f32.
    ``attn_fn`` is passed to :func:`forward` (default: the flash kernels
    on CUDA tensors)."""

    def f(params, batch, rng):
        del rng
        tokens = torch.as_tensor(batch["tokens"],
                                 device=params["embed"].device).long()
        logits = forward(params, tokens[:, :-1], cfg, mesh=mesh,
                         attn_fn=attn_fn)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, tokens[:, 1:, None])[..., 0]
        return nll.mean()

    return f
