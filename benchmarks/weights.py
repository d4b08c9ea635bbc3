"""The network's weights, made on the device from the seed: one draw of a
``torch.Generator`` for every leaf, in fp32 (the type the parameters are
held in), keyed as the port's ``EmbeddingNet`` state_dict. Both the program
and the reference get these same tensors."""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmarks.roofline import VGG_BLOCKS

MEAN_RGB = (123.68, 116.779, 103.939)


def leaf_shapes(clusters: int = 64, dim: int = 512) -> Dict[str, tuple]:
    shapes = {"vgg16.average_rgb": (3,)}
    for bi, block in enumerate(VGG_BLOCKS):
        for ci, (cin, cout) in enumerate(block):
            name = f"vgg16.block{bi + 1}.conv{bi + 1}_{ci + 1}"
            shapes[f"{name}.weight"] = (cout, cin, 3, 3)
            shapes[f"{name}.bias"] = (cout,)
    shapes["netvlad.cluster_centers"] = (dim, clusters)
    shapes["netvlad.assignment.weight"] = (clusters, dim, 1, 1)
    return shapes


def make_params(seed: int, device, clusters: int = 64) -> Dict[str, torch.Tensor]:
    """He-normal conv weights, small biases, the usual mean pixel, NetVLAD
    centers N(0, 1/512) and assignment weights of std 3 (a soft but not
    flat assignment of unit features)."""
    shapes = leaf_shapes(clusters)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    params, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        leaf = flat[at : at + n].view(shape)
        at += n
        if name.endswith("average_rgb"):
            leaf = torch.tensor(MEAN_RGB, device=device) + leaf
        elif "conv" in name and name.endswith(".weight"):
            leaf = leaf * math.sqrt(2.0 / (shape[1] * 9))
        elif name.endswith(".bias"):
            leaf = leaf * 0.01
        elif name.endswith("cluster_centers"):
            leaf = leaf / math.sqrt(shape[0])
        else:  # the assignment
            leaf = leaf * 3.0
        params[name] = leaf.contiguous()
    return params
