"""R(2+1)D / R3D video backbones and the TSP model with its heads.

Port of gvl_tpu/backbone/r2plus1d.py (reference
video_backbone/TSP/models/backbone.py and model.py): factored (2+1)D
convolutions with the paper's intermediate width, BasicBlocks (3, 4, 6, 3)
for the 34-layer net and (2, 2, 2, 2) for the 18-layer ones, stride-2
downsampling from stage 2, a mean pool to the 512-d clip feature; BatchNorm
eps 1e-3 for r2plus1d_34 (its IG65M weights) and 1e-5 otherwise.

Parameter names are torchvision's VideoResNet ones (stem.{0,1,3,4},
layer{1..4}.{b}.conv{1,2}.0.{0,1,3} for a (2+1)D conv, .conv{1,2}.1 the
block's norm, .downsample.{0,1}), so a released TSP / TAC backbone loads
with load_state_dict(strict=True) once its fc heads are stripped; the TSP
model holds it as `features` and its heads as `fc` (one label) or `fc1`,
`fc2` (two), as the reference Model does.

The public input is (N, T, H, W, 3), as in the JAX package; it is
permuted to torch's (N, 3, T, H, W) inside. BatchNorm follows flax's
rule, which the JAX package trains with: running statistics move by 0.01
of the batch's (momentum 0.99) with the biased batch variance, where
torch's BatchNorm3d moves by 0.1 with the unbiased one (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gvl_tpu_torch.models.layers import lecun_normal_

BLOCK_COUNTS = {"r2plus1d_34": (3, 4, 6, 3), "r2plus1d_18": (2, 2, 2, 2),
                "r3d_18": (2, 2, 2, 2)}
FEATURE_DIM = 512


def midplanes(in_c: int, out_c: int, t: int = 3, d: int = 3) -> int:
    """M_i of the R(2+1)D paper, torchvision's Conv2Plus1D width."""
    return (t * d * d * in_c * out_c) // (d * d * in_c + t * out_c)


def bn_eps(backbone: str) -> float:
    return 1e-3 if backbone == "r2plus1d_34" else 1e-5


class BatchNorm3d(nn.BatchNorm3d):
    """BatchNorm over (N, C, T, H, W) with flax's running-statistics rule:
    in training the batch's mean and biased variance normalise, and move
    the running ones by `momentum` (0.01); in eval the running ones
    normalise."""

    def __init__(self, channels: int, eps: float, device=None):
        super().__init__(channels, eps=eps, momentum=0.01, device=device)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            dims = (0, 2, 3, 4)
            xf = x.to(self.running_mean.dtype)
            self.running_mean.lerp_(xf.mean(dims), self.momentum)
            self.running_var.lerp_(xf.var(dims, correction=0), self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class Conv2Plus1D(nn.Sequential):
    """Spatial (1, 3, 3) conv, norm, ReLU, temporal (3, 1, 1) conv."""

    def __init__(self, in_c: int, out_c: int, stride: int, eps: float,
                 device=None):
        mid = midplanes(in_c, out_c)
        super().__init__(
            nn.Conv3d(in_c, mid, (1, 3, 3), (1, stride, stride), (0, 1, 1),
                      bias=False, device=device),
            BatchNorm3d(mid, eps, device=device), nn.ReLU(inplace=True),
            nn.Conv3d(mid, out_c, (3, 1, 1), (stride, 1, 1), (1, 0, 0),
                      bias=False, device=device))


def conv3d_simple(in_c: int, out_c: int, stride: int, eps: float,
                  device=None) -> nn.Conv3d:
    """R3D's full (3, 3, 3) conv."""
    del eps
    return nn.Conv3d(in_c, out_c, 3, stride, 1, bias=False, device=device)


class BasicBlock(nn.Module):
    def __init__(self, in_c: int, out_c: int, conv, stride: int, eps: float,
                 device=None):
        super().__init__()
        self.conv1 = nn.Sequential(conv(in_c, out_c, stride, eps, device),
                                   BatchNorm3d(out_c, eps, device=device),
                                   nn.ReLU(inplace=True))
        self.conv2 = nn.Sequential(conv(out_c, out_c, 1, eps, device),
                                   BatchNorm3d(out_c, eps, device=device))
        self.downsample = None
        if stride != 1 or in_c != out_c:
            self.downsample = nn.Sequential(
                nn.Conv3d(in_c, out_c, 1, stride, bias=False, device=device),
                BatchNorm3d(out_c, eps, device=device))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + identity)


class R2Plus1D(nn.Module):
    """The backbone: clips (N, T, H, W, 3), normalised, -> the mean-pooled
    clip feature (N, 512)."""

    def __init__(self, backbone: str = "r2plus1d_34", device=None):
        super().__init__()
        if backbone not in BLOCK_COUNTS:
            raise ValueError(f"unknown backbone {backbone!r}: one of "
                             f"{sorted(BLOCK_COUNTS)}")
        self.arch = backbone
        eps = bn_eps(backbone)
        if backbone == "r3d_18":
            conv = conv3d_simple
            self.stem = nn.Sequential(
                nn.Conv3d(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3), bias=False,
                          device=device),
                BatchNorm3d(64, eps, device=device), nn.ReLU(inplace=True))
        else:
            conv = Conv2Plus1D
            self.stem = nn.Sequential(
                nn.Conv3d(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3), bias=False,
                          device=device),
                BatchNorm3d(45, eps, device=device), nn.ReLU(inplace=True),
                nn.Conv3d(45, 64, (3, 1, 1), 1, (1, 0, 0), bias=False,
                          device=device),
                BatchNorm3d(64, eps, device=device), nn.ReLU(inplace=True))
        in_c = 64
        for stage, (c, n) in enumerate(zip((64, 128, 256, FEATURE_DIM),
                                           BLOCK_COUNTS[backbone])):
            blocks = []
            for b in range(n):
                stride = 2 if stage > 0 and b == 0 else 1
                blocks.append(BasicBlock(in_c, c, conv, stride, eps, device))
                in_c = c
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, clips):
        x = self.stem(clips.permute(0, 4, 1, 2, 3))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x.mean(dim=(2, 3, 4))


def head_names(n_heads: int):
    """The reference Model's head names: `fc` for one, `fc1`, `fc2`, ...
    for several (reference models/model.py:31-35)."""
    return ["fc"] if n_heads == 1 else [f"fc{i + 1}" for i in range(n_heads)]


class TSPModel(nn.Module):
    """The backbone (`features`) and one linear head per label kind over
    the feature, concatenated with a global video feature under use_gvf
    (which doubles the heads' input width), after a dropout of fc_dropout.
    forward(clips, gvf=None) -> (feature (N, 512), [logits per head])."""

    def __init__(self, num_classes_list: Sequence[int] = (200,),
                 backbone: str = "r2plus1d_34", use_gvf: bool = False,
                 fc_dropout: float = 0.5, device=None):
        super().__init__()
        self.num_classes_list = tuple(int(n) for n in num_classes_list)
        self.use_gvf = use_gvf
        self.features = R2Plus1D(backbone, device=device)
        self.dropout = nn.Dropout(fc_dropout)
        width = FEATURE_DIM * (2 if use_gvf else 1)
        self.heads = head_names(len(self.num_classes_list))
        for name, n in zip(self.heads, self.num_classes_list):
            setattr(self, name, nn.Linear(width, n, device=device))

    def forward(self, clips, gvf: Optional[torch.Tensor] = None):
        feat = self.features(clips)
        h = feat
        if self.use_gvf:
            if gvf is None:
                raise ValueError("TSPModel: use_gvf needs a global video "
                                 "feature")
            h = torch.cat([h, gvf.to(h.dtype)], dim=-1)
        h = self.dropout(h)
        return feat, [getattr(self, name)(h) for name in self.heads]


def init_backbone_params(model: nn.Module, generator: torch.Generator
                         ) -> None:
    """flax's default init, as the JAX package's model gets it: conv and
    dense kernels lecun-normal, biases 0, norms scale 1 and bias 0, running
    statistics 0 and 1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv3d, nn.Linear)):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm3d):
                m.reset_parameters()
