"""DNN workload descriptors (paper Table 3) + HPCG.

Per-layer configurations of AlexNet, GoogLeNet, VGG-16, ResNet-18 and
SqueezeNet for ImageNet (224x224). Tests validate total weights / MACs
against Table 3 (61M/724M, 7M/1.43G, 138M/15.5G, 11.8M/2G, 1.2M/837M).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class Layer:
    name: str
    kind: str          # conv | fc
    in_ch: int
    out_ch: int
    k: int = 1
    stride: int = 1
    in_hw: int = 0     # input spatial size (square)
    groups: int = 1
    pad: int = -1      # -1 -> 'same-ish' (k//2)

    @property
    def out_hw(self) -> int:
        if self.kind == "fc":
            return 1
        p = self.k // 2 if self.pad < 0 else self.pad
        return (self.in_hw + 2 * p - self.k) // self.stride + 1

    @property
    def weights(self) -> int:
        if self.kind == "fc":
            return self.in_ch * self.out_ch
        return (self.in_ch // self.groups) * self.out_ch * self.k * self.k

    @property
    def macs(self) -> int:
        if self.kind == "fc":
            return self.in_ch * self.out_ch
        return self.weights * self.out_hw * self.out_hw

    @property
    def in_bytes(self) -> int:   # fp32 activations
        if self.kind == "fc":
            return self.in_ch * 4
        return self.in_ch * self.in_hw * self.in_hw * 4

    @property
    def out_bytes(self) -> int:
        if self.kind == "fc":
            return self.out_ch * 4
        return self.out_ch * self.out_hw * self.out_hw * 4

    @property
    def weight_bytes(self) -> int:
        return self.weights * 4


@dataclasses.dataclass(frozen=True)
class Network:
    name: str
    layers: Tuple[Layer, ...]
    top5_error: float

    @property
    def total_weights(self) -> int:
        return sum(l.weights for l in self.layers)

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)

    @property
    def conv_layers(self) -> int:
        return sum(1 for l in self.layers if l.kind == "conv")

    @property
    def fc_layers(self) -> int:
        return sum(1 for l in self.layers if l.kind == "fc")


def _conv(name, in_ch, out_ch, k, s, hw, groups=1, pad=-1):
    return Layer(name, "conv", in_ch, out_ch, k, s, hw, groups, pad)


def _fc(name, i, o):
    return Layer(name, "fc", i, o)


# --- AlexNet ----------------------------------------------------------------

ALEXNET = Network("AlexNet", (
    _conv("conv1", 3, 96, 11, 4, 224, pad=2),     # 55
    _conv("conv2", 96, 256, 5, 1, 27, groups=2),
    _conv("conv3", 256, 384, 3, 1, 13),
    _conv("conv4", 384, 384, 3, 1, 13, groups=2),
    _conv("conv5", 384, 256, 3, 1, 13, groups=2),
    _fc("fc6", 9216, 4096),
    _fc("fc7", 4096, 4096),
    _fc("fc8", 4096, 1000),
), top5_error=16.4)


# --- VGG-16 -----------------------------------------------------------------

def _vgg():
    cfg = [(64, 224), (64, 224), (128, 112), (128, 112),
           (256, 56), (256, 56), (256, 56),
           (512, 28), (512, 28), (512, 28),
           (512, 14), (512, 14), (512, 14)]
    layers: List[Layer] = []
    in_ch = 3
    for i, (c, hw) in enumerate(cfg):
        layers.append(_conv(f"conv{i+1}", in_ch, c, 3, 1, hw))
        in_ch = c
    layers += [_fc("fc1", 25088, 4096), _fc("fc2", 4096, 4096),
               _fc("fc3", 4096, 1000)]
    return Network("VGG-16", tuple(layers), top5_error=7.3)


VGG16 = _vgg()


# --- ResNet-18 ---------------------------------------------------------------

def _resnet18():
    layers = [_conv("conv1", 3, 64, 7, 2, 224, pad=3)]
    hw = 56
    in_ch = 64
    stage_cfg = [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]
    for c, blocks, first_stride in stage_cfg:
        for b in range(blocks):
            s = first_stride if b == 0 else 1
            layers.append(_conv(f"s{c}b{b}c1", in_ch, c, 3, s, hw))
            hw_out = layers[-1].out_hw
            layers.append(_conv(f"s{c}b{b}c2", c, c, 3, 1, hw_out))
            if b == 0 and (s != 1 or in_ch != c):
                layers.append(_conv(f"s{c}b{b}ds", in_ch, c, 1, s, hw, pad=0))
            in_ch = c
            hw = hw_out
    layers.append(_fc("fc", 512, 1000))
    return Network("ResNet-18", tuple(layers), top5_error=10.71)


RESNET18 = _resnet18()


# --- GoogLeNet ---------------------------------------------------------------

def _inception(name, hw, in_ch, c1, c3r, c3, c5r, c5, pp):
    return [
        _conv(f"{name}.1x1", in_ch, c1, 1, 1, hw, pad=0),
        _conv(f"{name}.3x3r", in_ch, c3r, 1, 1, hw, pad=0),
        _conv(f"{name}.3x3", c3r, c3, 3, 1, hw),
        _conv(f"{name}.5x5r", in_ch, c5r, 1, 1, hw, pad=0),
        _conv(f"{name}.5x5", c5r, c5, 5, 1, hw),
        _conv(f"{name}.pool", in_ch, pp, 1, 1, hw, pad=0),
    ]


def _googlenet():
    layers = [
        _conv("conv1", 3, 64, 7, 2, 224, pad=3),
        _conv("conv2r", 64, 64, 1, 1, 56, pad=0),
        _conv("conv2", 64, 192, 3, 1, 56),
    ]
    inc = [
        ("3a", 28, 192, 64, 96, 128, 16, 32, 32),
        ("3b", 28, 256, 128, 128, 192, 32, 96, 64),
        ("4a", 14, 480, 192, 96, 208, 16, 48, 64),
        ("4b", 14, 512, 160, 112, 224, 24, 64, 64),
        ("4c", 14, 512, 128, 128, 256, 24, 64, 64),
        ("4d", 14, 512, 112, 144, 288, 32, 64, 64),
        ("4e", 14, 528, 256, 160, 320, 32, 128, 128),
        ("5a", 7, 832, 256, 160, 320, 32, 128, 128),
        ("5b", 7, 832, 384, 192, 384, 48, 128, 128),
    ]
    for args in inc:
        layers += _inception(*args)
    layers.append(_fc("fc", 1024, 1000))
    return Network("GoogLeNet", tuple(layers), top5_error=6.7)


GOOGLENET = _googlenet()


# --- SqueezeNet (v1.0) --------------------------------------------------------

def _fire(name, hw, in_ch, sq, e1, e3):
    return [
        _conv(f"{name}.sq", in_ch, sq, 1, 1, hw, pad=0),
        _conv(f"{name}.e1", sq, e1, 1, 1, hw, pad=0),
        _conv(f"{name}.e3", sq, e3, 3, 1, hw),
    ]


def _squeezenet():
    layers = [_conv("conv1", 3, 96, 7, 2, 224, pad=0)]  # 109 -> pool 54
    fires = [
        ("f2", 54, 96, 16, 64, 64), ("f3", 54, 128, 16, 64, 64),
        ("f4", 54, 128, 32, 128, 128), ("f5", 27, 256, 32, 128, 128),
        ("f6", 27, 256, 48, 192, 192), ("f7", 27, 384, 48, 192, 192),
        ("f8", 27, 384, 64, 256, 256), ("f9", 13, 512, 64, 256, 256),
    ]
    for args in fires:
        layers += _fire(*args)
    layers.append(_conv("conv10", 512, 1000, 1, 1, 13, pad=0))
    return Network("SqueezeNet", tuple(layers), top5_error=16.4)


SQUEEZENET = _squeezenet()

NETWORKS = {n.name: n for n in
            (ALEXNET, GOOGLENET, VGG16, RESNET18, SQUEEZENET)}


# --- HPCG (non-DL HPC workload; paper Fig 3) --------------------------------
# 27-point stencil SpMV dominates: reads ~ 27 matrix entries + vector per
# row, one vector write per row. R/W rises with grid size as the working
# set exceeds cache (less vector reuse). Counts are per CG iteration x 50.


@dataclasses.dataclass(frozen=True)
class HPCGWorkload:
    name: str
    grid: int          # local subgrid dimension (n -> n^3 rows)
    rw_ratio: float    # measured-range read/write transaction ratio (Fig 3)

    @property
    def rows(self) -> int:
        return self.grid ** 3

    def transactions(self, iters: int = 50) -> Tuple[float, float]:
        """(reads, writes) L2 transactions per run."""
        values_per_line = 16          # 128B line / 8B double
        writes = self.rows * iters / values_per_line
        return writes * self.rw_ratio, writes


HPCG_S = HPCGWorkload("HPCG-S", 8, 2.3)
HPCG_M = HPCGWorkload("HPCG-M", 32, 12.0)
HPCG_L = HPCGWorkload("HPCG-L", 128, 26.0)
HPCG = {w.name: w for w in (HPCG_S, HPCG_M, HPCG_L)}
