"""Weights from the seed, made on the device in a few large draws, as the
reference's modules name them (the program's state_dict names).

Every dense weight and bias U(+-1/sqrt(fan_in)); embedding tables
N(0, 1); the decoder's seed set U(0, 1); norms scale 1 and bias 0,
batch-norm statistics mean 0 and variance 1, ActNorm the identity, the
grouper's affine the identity. The decoder's latent projections
(`decoder.*.ln.weight`) are multiplied by `DECODER_LATENT_GAIN`: random
Score weights drive the sampler's latents to |x| ~ 5e3, where a decoder
drawn for unit latents has near one-hot attention and any rounding moves a
cloud by most of its scale; the gain puts its inputs at the scale a
trained decoder sees.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import models as ref

DECODER_LATENT_GAIN = 1e-3


def generator(seed: int, stream: int, device) -> torch.Generator:
    """An independent generator for stream `stream` of run `seed`."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + stream) % (2 ** 63))


@torch.no_grad()
def fill(module: torch.nn.Module, seed: int, stream: int):
    """Draw `module`'s weights in place; returns it."""
    dev = next(module.parameters()).device
    uniform, normal = [], []
    for name, m in module.named_modules():
        if isinstance(m, ref.Linear):
            bound = 1.0 / math.sqrt(m.weight.shape[1])
            gain = DECODER_LATENT_GAIN \
                if name.startswith("decoder.") and name.endswith(".ln") \
                else 1.0
            uniform += [(m.weight, bound * gain), (m.bias, bound)]
        elif isinstance(m, torch.nn.Embedding):
            normal.append(m.weight)
        elif isinstance(m, ref.InitSet):
            uniform.append((m.prior, None))
    g = generator(seed, stream, dev)
    flat = torch.rand(sum(t.numel() for t, _ in uniform), generator=g,
                      device=dev)
    at = 0
    for t, bound in uniform:
        part = flat[at:at + t.numel()].view_as(t)
        at += t.numel()
        if bound is None:
            t.copy_(part)
        else:
            t.copy_(part).mul_(2.0).sub_(1.0).mul_(bound)
    del flat
    if normal:
        flat = torch.randn(sum(t.numel() for t in normal), generator=g,
                           device=dev)
        at = 0
        for t in normal:
            t.copy_(flat[at:at + t.numel()].view_as(t))
            at += t.numel()
    return module


def score(cfg: dict, seed: int, device) -> ref.Score:
    with torch.device(device):
        net = ref.Score(cfg["score"])
    return fill(net, seed, 1)


def compressor(cfg: dict, seed: int, device) -> ref.Compressor:
    with torch.device(device):
        net = ref.Compressor(cfg["compressor"])
    return fill(net, seed, 2)
