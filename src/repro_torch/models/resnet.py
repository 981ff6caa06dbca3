"""Paper-native ResNet-56/110 (bottleneck) with the DTFL md1..md8 modules.

Pair: ``repro/models/resnet.py:1``. Same parameter trees (HWIO conv
weights), NHWC activations and module plan (DTFL Appendix A.5, Tables
8/9/10; GroupNorm(8) in place of BatchNorm).

Every apply function takes a LEADING CLIENT AXIS C on parameters and
activations: a conv weight is (C, k, k, cin, cout), an activation
(C, N, H, W, ch). A tier's cohort thus runs as batched GEMMs
(``torch.matmul`` on (C, N*H*W, k*k*cin) @ (C, k*k*cin, cout)), where the
JAX package ``jax.vmap``s the single-client functions. Single-model paths
use C = 1. ``init``/``aux_init`` build one model without the client axis.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

Params = Any


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def conv_init(gen: torch.Generator, k: int, cin: int, cout: int) -> torch.Tensor:
    fan_in = k * k * cin
    return torch.randn((k, k, cin, cout), generator=gen) * math.sqrt(2.0 / fan_in)


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME conv as im2col + batched matmul (``repro/models/resnet.py:39``).

    x (C, N, H, W, cin), w (C, k, k, cin, cout). SAME padding is asymmetric
    exactly as XLA's: a stride-2 3x3 conv on an even input pads (0, 1)."""
    C, k, _, cin, cout = w.shape
    _, N, H, W, _ = x.shape
    if k == 1:
        xs = x[:, :, ::stride, ::stride, :]
        oh, ow = xs.shape[2], xs.shape[3]
        out = torch.matmul(xs.reshape(C, N * oh * ow, cin), w.reshape(C, cin, cout))
        return out.reshape(C, N, oh, ow, cout)
    oh, ow = -(-H // stride), -(-W // stride)
    ph = max((oh - 1) * stride + k - H, 0)
    pw = max((ow - 1) * stride + k - W, 0)
    xp = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    cols = [
        xp[:, :, i : i + stride * (oh - 1) + 1 : stride,
           j : j + stride * (ow - 1) + 1 : stride, :]
        for i in range(k)
        for j in range(k)
    ]
    patches = torch.cat(cols, dim=-1).reshape(C, N * oh * ow, k * k * cin)
    out = torch.matmul(patches, w.reshape(C, k * k * cin, cout))
    return out.reshape(C, N, oh, ow, cout)


def groupnorm(x: torch.Tensor, scale, bias, groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """x (C, N, H, W, ch); scale, bias (C, ch).

    The variance is the population variance (``repro/models/resnet.py:71``,
    ``jnp.var``), computed as jnp.var does: the mean of the squared
    deviations from the mean (``torch.var`` would default to unbiased)."""
    C, N, H, W, ch = x.shape
    g = min(groups, ch)
    while ch % g:
        g -= 1
    xg = x.reshape(C, N, H, W, g, ch // g)
    mu = xg.mean(dim=(2, 3, 5), keepdim=True)
    d = xg - mu
    var = (d * d).mean(dim=(2, 3, 5), keepdim=True)
    xg = d * torch.rsqrt(var + eps)
    return (xg.reshape(C, N, H, W, ch) * scale[:, None, None, None, :]
            + bias[:, None, None, None, :])


def gn_init(c: int) -> Params:
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


# ---------------------------------------------------------------------------
# bottleneck block
# ---------------------------------------------------------------------------

def bottleneck_init(gen: torch.Generator, cin: int, mid: int, cout: int,
                    downsample: bool) -> Params:
    p = {
        "conv1": conv_init(gen, 1, cin, mid),
        "gn1": gn_init(mid),
        "conv2": conv_init(gen, 3, mid, mid),
        "gn2": gn_init(mid),
        "conv3": conv_init(gen, 1, mid, cout),
        "gn3": gn_init(cout),
    }
    if downsample:
        p["down"] = conv_init(gen, 1, cin, cout)
    return p


def bottleneck_apply(x: torch.Tensor, p: Params, stride: int) -> torch.Tensor:
    h = torch.relu(groupnorm(conv(x, p["conv1"]), **p["gn1"]))
    h = torch.relu(groupnorm(conv(h, p["conv2"], stride), **p["gn2"]))
    h = groupnorm(conv(h, p["conv3"]), **p["gn3"])
    if "down" in p:
        x = conv(x, p["down"], stride)
    return torch.relu(x + h)


# ---------------------------------------------------------------------------
# full network
# ---------------------------------------------------------------------------

def _block_plan(cfg) -> list[dict]:
    """One entry per bottleneck block: channels, stride, module id (2..7)."""
    n = cfg.blocks_per_stage
    w = cfg.width
    plan = []
    cin = w
    for stage, (mid, cout, stride) in enumerate(
        [(w, 4 * w, 1), (2 * w, 8 * w, 2), (4 * w, 16 * w, 2)]
    ):
        for i in range(n):
            plan.append(
                dict(
                    cin=cin,
                    mid=mid,
                    cout=cout,
                    stride=stride if i == 0 else 1,
                    down=(i == 0),
                    module=2 + 2 * stage + (0 if i < max(1, n // 2) else 1),
                )
            )
            cin = cout
    return plan


def init(gen: torch.Generator, cfg) -> Params:
    """One model (no client axis), fp32 on the CPU, drawn from ``gen``."""
    plan = _block_plan(cfg)
    return {
        "stem": {"conv": conv_init(gen, 3, 3, cfg.width), "gn": gn_init(cfg.width)},
        "blocks": [
            bottleneck_init(gen, b["cin"], b["mid"], b["cout"], b["down"])
            for b in plan
        ],
        "fc": {
            "w": torch.randn((16 * cfg.width, cfg.n_classes), generator=gen) * 0.01,
            "b": torch.zeros(cfg.n_classes),
        },
    }


def n_blocks_in_modules(cfg, upto_module: int) -> int:
    """Number of bottleneck blocks contained in modules md2..md{upto}."""
    return sum(1 for b in _block_plan(cfg) if b["module"] <= upto_module)


def _stem(p: Params, images: torch.Tensor) -> torch.Tensor:
    return torch.relu(groupnorm(conv(images, p["stem"]["conv"]), **p["stem"]["gn"]))


def forward_features(params: Params, cfg, images: torch.Tensor,
                     upto_module: int = 8) -> torch.Tensor:
    """Run stem + blocks of modules <= upto_module. images: (C, N, H, W, 3)."""
    x = _stem(params, images)
    for bp, plan in zip(params["blocks"], _block_plan(cfg)):
        if plan["module"] > upto_module:
            break
        x = bottleneck_apply(x, bp, plan["stride"])
    return x


def head_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    return aux_apply(params["fc"], x)


def forward(params: Params, cfg, images: torch.Tensor) -> torch.Tensor:
    return head_apply(params, forward_features(params, cfg, images, 8))


# ---------------------------------------------------------------------------
# DTFL split: client modules [1..m], server modules (m..8], aux = avgpool+fc
# ---------------------------------------------------------------------------

def client_forward(client: Params, cfg, images: torch.Tensor) -> torch.Tensor:
    x = _stem(client, images)
    for bp, pl in zip(client["blocks"], _block_plan(cfg)):
        x = bottleneck_apply(x, bp, pl["stride"])
    return x


def server_forward(server: Params, cfg, z: torch.Tensor, tier_module: int) -> torch.Tensor:
    plan = _block_plan(cfg)[n_blocks_in_modules(cfg, tier_module):]
    x = z
    for bp, pl in zip(server["blocks"], plan):
        x = bottleneck_apply(x, bp, pl["stride"])
    return head_apply({"fc": server["fc"]}, x)


def aux_channels(cfg, tier_module: int) -> int:
    """Channel width at the output of module ``tier_module`` (Table 10 fc input)."""
    nb = n_blocks_in_modules(cfg, tier_module)
    if nb == 0:
        return cfg.width
    return _block_plan(cfg)[nb - 1]["cout"]


def aux_init(gen: torch.Generator, cfg, tier_module: int) -> Params:
    c = aux_channels(cfg, tier_module)
    return {
        "w": torch.randn((c, cfg.n_classes), generator=gen) * 0.01,
        "b": torch.zeros(cfg.n_classes),
    }


def aux_apply(aux: Params, z: torch.Tensor) -> torch.Tensor:
    """avgpool + fc: z (C, N, H, W, ch), w (C, ch, classes) -> (C, N, classes)."""
    pooled = z.mean(dim=(2, 3))
    return torch.matmul(pooled, aux["w"]) + aux["b"][:, None, :]
