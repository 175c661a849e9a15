"""The paper's own experiment models, in the JAX package's layouts.

* MNIST model (§7.4.3): a deep fully-connected network — 20 hidden layers
  of 50 ReLU units + 10-way softmax head.
* CIFAR model (§5): CNN with conv32-conv32-pool, conv64-conv64-pool,
  dense-512, softmax (ReLU activations).

The public functions keep :mod:`repro.nn.paper_models`' layouts: inputs are
NHWC, conv kernels HWIO, dense weights ``(in, out)``.  Only :func:`_conv`
permutes, to PyTorch's NCHW/OIHW, and back; the flatten before ``fc`` runs
over NHWC, so carried-over ``fc`` rows line up.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.nn.param import ParamDef

PyTree = Any


def mlp_classifier_template(
    in_dim: int, n_classes: int, *, width: int = 50, depth: int = 20,
    dtype=torch.float32,
) -> Dict[str, Any]:
    layers = {}
    d = in_dim
    for i in range(depth):
        layers[f"h{i}"] = {
            "w": ParamDef((d, width), (None, None), init="scaled", scale=1.4, dtype=dtype),
            "b": ParamDef((width,), (None,), init="zeros", dtype=dtype),
        }
        d = width
    layers["out"] = {
        "w": ParamDef((d, n_classes), (None, None), init="scaled", dtype=dtype),
        "b": ParamDef((n_classes,), (None,), init="zeros", dtype=dtype),
    }
    return layers


def mlp_classifier_apply(params, x: torch.Tensor) -> torch.Tensor:
    """x: (b, in_dim) -> logits (b, n_classes)."""
    h = x
    i = 0
    while f"h{i}" in params:
        p = params[f"h{i}"]
        h = torch.relu(h @ p["w"] + p["b"])
        i += 1
    p = params["out"]
    return h @ p["w"] + p["b"]


def cnn_classifier_template(
    hw: int = 32, channels: int = 3, n_classes: int = 10, dtype=torch.float32,
) -> Dict[str, Any]:
    """The paper's CIFAR CNN (2xconv32, pool, 2xconv64, pool, dense512)."""

    def conv(cin, cout):
        return {
            "w": ParamDef((3, 3, cin, cout), (None, None, None, None),
                          init="conv_scaled", dtype=dtype),
            "b": ParamDef((cout,), (None,), init="zeros", dtype=dtype),
        }

    flat = (hw // 4) * (hw // 4) * 64
    return {
        "c1": conv(channels, 32),
        "c2": conv(32, 32),
        "c3": conv(32, 64),
        "c4": conv(64, 64),
        "fc": {
            "w": ParamDef((flat, 512), (None, None), init="scaled", dtype=dtype),
            "b": ParamDef((512,), (None,), init="zeros", dtype=dtype),
        },
        "out": {
            "w": ParamDef((512, n_classes), (None, None), init="scaled", dtype=dtype),
            "b": ParamDef((n_classes,), (None,), init="zeros", dtype=dtype),
        },
    }


def _conv(p, x):
    """3x3 stride-1 ``SAME`` conv + bias + ReLU on NHWC input, HWIO kernel."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1), padding=1)
    return torch.relu(y.permute(0, 2, 3, 1) + p["b"])


def _maxpool(x):
    """2x2 stride-2 ``VALID`` max-pool over NHWC (odd edges dropped)."""
    b, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def cnn_classifier_apply(params, x: torch.Tensor) -> torch.Tensor:
    """x: (b, h, w, c) NHWC -> logits."""
    x = _conv(params["c1"], x)
    x = _maxpool(_conv(params["c2"], x))
    x = _conv(params["c3"], x)
    x = _maxpool(_conv(params["c4"], x))
    x = x.reshape(x.shape[0], -1)                 # NHWC flatten order
    x = torch.relu(x @ params["fc"]["w"] + params["fc"]["b"])
    return x @ params["out"]["w"] + params["out"]["b"]


def classifier_loss(apply_fn, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits = apply_fn(params, batch["x"]).float()
    labels = batch["y"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return loss, {"acc": acc}
