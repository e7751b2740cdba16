"""VGG16 features, the perceptual loss and LPIPS
(image_restoration_tpu/eval/perceptual.py), NCHW.

* TransWeather's perceptual loss (TransWeather-main/perceptual.py:8-33,
  train.py:161-164): the mean over relu1_2 / relu2_2 / relu3_3
  (torchvision ``features`` indices 3/8/15) of the feature MSE.
* LPIPS-vgg (MoCE-IR-main/src/test.py:88, torchmetrics'
  ``LearnedPerceptualImagePatchSimilarity(net_type='vgg',
  normalize=True)``): relu1_2..relu5_3 features, unit-normalised over the
  channels, squared differences through learned 1x1 heads, spatial means
  summed.

Pretrained weights are data the repo does not ship: ``VGG16Features``
holds torchvision's ``features`` layout (``features.N.weight``), so a
torchvision ``vgg16`` state_dict loads through :func:`vgg16_key_map`, and
an LPIPS checkpoint (the heads' ``lin{i}.model.1.weight`` and the trunk
under ``net.``) through :func:`lpips_key_map`. With random weights both
are still valid, untrained, feature metrics.
"""

from __future__ import annotations

import re
from typing import Sequence

import torch
from torch import nn

from image_restoration_tpu_torch.ops.common import Conv

# torchvision VGG16 ``features``: conv widths and pools
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# LPIPS 'vgg' scaling layer (lpips.ScalingLayer)
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)
# torchvision ``features`` index of each ReLU tap
RELU_TAPS = {"relu1_2": 3, "relu2_2": 8, "relu3_3": 15,
             "relu4_3": 22, "relu5_3": 29}


class VGG16Features(nn.Module):
    """torchvision's VGG16 ``features`` up to the last of ``taps``; returns
    the outputs of the layers at the ``taps`` indices."""

    def __init__(self, taps: Sequence[int] = (3, 8, 15), dtype=None):
        super().__init__()
        self.taps = tuple(taps)
        layers, cin = [], 3
        for v in VGG16_CFG:
            if len(layers) > max(self.taps):
                break
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [Conv(cin, v, 3, padding=1, dtype=dtype),
                           nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers[: max(self.taps) + 1])

    def forward(self, x):
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.taps:
                outs.append(x)
        return outs


def _channels(values, like):
    return torch.tensor(values, dtype=like.dtype,
                        device=like.device).reshape(1, -1, 1, 1)


def perceptual_loss(vgg: VGG16Features, pred, gt, criterion: str = "mse",
                    normalize: bool = True):
    """TransWeather's LossNetwork: the mean over ``vgg``'s taps of the
    feature MSE (or L1) of ``pred`` and ``gt``, [0, 1] images normalised
    by ImageNet's statistics first when ``normalize``."""
    if normalize:
        mean, std = _channels(IMAGENET_MEAN, pred), _channels(IMAGENET_STD,
                                                              pred)
        pred, gt = (pred - mean) / std, (gt - mean) / std
    losses = []
    for a, b in zip(vgg(pred), vgg(gt)):
        d = a - b
        losses.append(torch.mean(d * d) if criterion == "mse"
                      else torch.mean(torch.abs(d)))
    return sum(losses) / len(losses)


class LPIPS(nn.Module):
    """LPIPS-vgg: ``forward(x, y)`` -> (B,) distances of [0, 1] images
    (of [-1, 1] ones with ``normalize=False``)."""

    def __init__(self, dtype=None):
        super().__init__()
        taps = tuple(RELU_TAPS[k] for k in
                     ("relu1_2", "relu2_2", "relu3_3", "relu4_3", "relu5_3"))
        self.net = VGG16Features(taps, dtype)
        for i, c in enumerate((64, 128, 256, 512, 512)):
            setattr(self, f"lin{i}", Conv(c, 1, 1, bias=False, dtype=dtype))

    def forward(self, x, y, normalize: bool = True):
        if normalize:  # [0, 1] -> [-1, 1] (torchmetrics normalize=True)
            x, y = 2.0 * x - 1.0, 2.0 * y - 1.0
        shift, scale = _channels(LPIPS_SHIFT, x), _channels(LPIPS_SCALE, x)
        fx = self.net((x - shift) / scale)
        fy = self.net((y - shift) / scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
            d = getattr(self, f"lin{i}")((a - b) ** 2)
            total = total + torch.mean(d, dim=(1, 2, 3))
        return total


def vgg16_key_map(key: str):
    """A torchvision vgg16 state_dict's key onto :class:`VGG16Features`':
    ``features.N`` is the module's own layout; the classifier is dropped
    (the trunk never uses it)."""
    if key.startswith("classifier"):
        return None
    return key


def lpips_key_map(key: str):
    """An LPIPS checkpoint's key onto :class:`LPIPS`': the heads'
    ``lin{i}.model.1.weight`` are ``lin{i}.weight``; the trunk under
    ``net.`` keeps torchvision's layout."""
    m = re.fullmatch(r"lin(\d)\.model\.1\.weight", key)
    return f"lin{m.group(1)}.weight" if m else key
