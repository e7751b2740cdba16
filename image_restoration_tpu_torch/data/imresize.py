"""MATLAB-protocol ``imresize`` (bicubic with antialiasing).

The SR literature's LR images are produced by MATLAB's imresize, whose
bicubic kernel + antialiasing differ from PIL/cv2; the reference vendors a
python port (MoCE-IR-main/src/utils/imresize.py:6-229) used for on-the-fly
LR synthesis. This is an independent implementation of the same protocol
(Keys cubic a=-0.5, kernel widened by 1/scale with antialiasing when
downscaling, symmetric boundary replication, separable per-axis application),
formulated as precomputed gather+matmul. A copy of the numpy path of
image_restoration_tpu/data/imresize.py (its ``jnp`` path is not ported).

API: ``imresize(im, scale_factor=None, output_shape=None, kernel='cubic',
antialiasing=True)`` with im (H,W) or (H,W,C), float in any range.
"""

from __future__ import annotations

import math

import numpy as np


def cubic(x):
    """Keys bicubic, a = -0.5 (MATLAB's 'cubic')."""
    x = np.asarray(x, np.float64)
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return ((1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0)
            * ((ax > 1) & (ax <= 2)))


def box(x):
    x = np.asarray(x, np.float64)
    return ((-0.5 <= x) & (x < 0.5)) * 1.0


def _sinc(x):
    return np.sinc(x)


def lanczos2(x):
    x = np.asarray(x, np.float64)
    return _sinc(x) * _sinc(x / 2) * (np.abs(x) < 2)


def lanczos3(x):
    x = np.asarray(x, np.float64)
    return _sinc(x) * _sinc(x / 3) * (np.abs(x) < 3)


KERNELS = {
    "cubic": (cubic, 4.0),
    "box": (box, 1.0),
    "lanczos2": (lanczos2, 4.0),
    "lanczos3": (lanczos3, 6.0),
}


def contributions(in_length: int, out_length: int, scale: float,
                  kernel: str = "cubic", antialiasing: bool = True,
                  boundary: str = "mirror"):
    """MATLAB's weight/index tables for one axis.

    Returns (weights (out, P), field_of_view (out, P) int indices into the
    input axis), with all-zero weight columns dropped.

    boundary:
    * 'mirror' — true MATLAB semantics: weights are the full kernel
      (normalized before folding) and out-of-range taps read mirrored
      pixels via aux = [1..n, n..1].
    * 'renorm' — the reference python port's behavior
      (MoCE-IR-main/src/utils/imresize.py:112-117: field_of_view is cast to
      np.uint BEFORE the kernel is evaluated, so NEGATIVE taps wrap to huge
      values, get kernel weight 0, and the remaining weights renormalize;
      right-of-range taps keep their kernel weight and mirror like MATLAB —
      the quirk is asymmetric). Byte-exact with the reference's LR synthesis.
    """
    kern, width = KERNELS[kernel]
    if scale < 1 and antialiasing:
        # widen the kernel to low-pass before decimation
        h = lambda x: scale * kern(scale * np.asarray(x, np.float64))
        width = width / scale
    else:
        h = kern

    x = np.arange(1, out_length + 1, dtype=np.float64)
    # output->input coordinate map (MATLAB convention, 1-based centers)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - width / 2)
    p = int(math.ceil(width)) + 2
    indices = left[:, None] + np.arange(p)[None, :] - 1  # 0-based candidates
    if boundary == "renorm":
        weights = np.where(indices >= 0, h(u[:, None] - indices - 1), 0.0)
    else:
        weights = h(u[:, None] - indices - 1)
    s = np.sum(weights, axis=1, keepdims=True)
    s[s == 0] = 1.0
    weights = weights / s
    # symmetric replication at the borders: aux = [1..n, n..1]
    aux = np.concatenate([np.arange(in_length),
                          np.arange(in_length)[::-1]])
    fov = aux[np.mod(indices.astype(np.int64), 2 * in_length)]
    keep = ~np.all(weights == 0, axis=0)
    return weights[:, keep], fov[:, keep]


def _fix_scale_and_shape(in_shape, scale_factor, output_shape):
    if scale_factor is not None:
        if np.isscalar(scale_factor):
            scale_factor = [scale_factor, scale_factor]
        scale = list(scale_factor)
        out = [int(math.ceil(s * d)) for s, d in zip(scale, in_shape[:2])]
    elif output_shape is not None:
        out = list(output_shape[:2])
        scale = [o / d for o, d in zip(out, in_shape[:2])]
    else:
        raise ValueError("need scale_factor or output_shape")
    return scale, out


def resize_plan(in_shape, scale_factor=None, output_shape=None,
                kernel: str = "cubic", antialiasing: bool = True,
                boundary: str = "mirror"):
    """Precompute per-axis (weights, indices); reusable across a dataset of
    same-shaped images."""
    scale, out = _fix_scale_and_shape(in_shape, scale_factor, output_shape)
    plan = []
    # process dims in order of increasing scale (MATLAB's dim order rule)
    order = np.argsort(scale)
    for dim in order:
        if scale[dim] == 1.0:
            continue
        # antialias widening applies only when downscaling (imresize.py:25)
        aa = antialiasing and scale[dim] < 1
        w, fov = contributions(in_shape[dim], out[dim], scale[dim], kernel,
                               aa, boundary)
        plan.append((int(dim), w, fov))
    return plan, out


def _apply_plan_np(im, plan):
    out = np.asarray(im, np.float64)
    for dim, w, fov in plan:
        moved = np.moveaxis(out, dim, 0)
        gathered = moved[fov]                      # (out, P, ...)
        res = np.einsum("op,op...->o...", w, gathered)
        out = np.moveaxis(res, 0, dim)
    return out


def imresize(im, scale_factor=None, output_shape=None, kernel: str = "cubic",
             antialiasing: bool = True, boundary: str = "mirror"):
    """MATLAB imresize: array in -> float64 numpy out. ``boundary='renorm'``
    reproduces the reference port's border handling exactly."""
    plan, _ = resize_plan(im.shape, scale_factor, output_shape, kernel,
                          antialiasing, boundary)
    return _apply_plan_np(im, plan)
