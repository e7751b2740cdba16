"""Padded channel layouts: how the kernel APIs run every channel width.

The raw kernels take only some widths: K1-K4 and K7 multiples of 16 (the
16-wide fragments of their products), K5 and K6 head widths in
``kernels/attn_core.py`` ``HEAD_WIDTHS``, K8 multiples of 16 up to 128. The
JAX kernels take every width by padding C onto their 128-lane canvas
(``block_pallas.py`` ``canvas_pad``) and taking the LayerNorm statistics
over the real channels only. The port's kernel APIs (``fused_block``,
``fused_drs_block``, ``ln_qkv_dwconv``, ``fused_mdta_core``,
``fused_ln_gdfn``, ``fused_mefc_steps``) do the same in a padded channel
space of their own, which :class:`Layout` describes:

* each of the ``heads`` heads is padded on its own, with its pads at its
  end: real channel j of head i goes to ``i * chp + j``, and the padded
  width is ``cp = heads * chp``. With one head this is plain tail padding;
* every pad of the input, of the weights and of the biases is zero, so a
  pad channel stays exactly 0 through every kernel (the LayerNorms' affine
  is 0 there and their statistics count ``c_real`` channels);
* weights map by the same channel index on every axis that is a channel
  axis (:func:`pad_channels` with ``slots`` for the [q | k | v] rows of the
  qkv 1x1).

Each API pads its input once, runs its kernels in the padded space, and
unpads its output once; the attention's finalize runs at the real width
between them (:func:`real_stats`, :func:`pad_square`), so no padded key
enters a softmax or a top-k. At a width the raw kernel takes, the layout
is the identity and these functions return their input.
"""

from __future__ import annotations

from typing import NamedTuple

import torch.nn.functional as F


def round16(n: int) -> int:
    return -(-n // 16) * 16


class Layout(NamedTuple):
    """``c`` real channels in ``heads`` heads, each padded to ``chp``."""

    c: int
    heads: int
    chp: int

    @property
    def ch(self) -> int:
        return self.c // self.heads

    @property
    def cp(self) -> int:
        return self.heads * self.chp

    @property
    def padded(self) -> bool:
        return self.chp != self.ch


def head_layout(c: int, heads: int, chp: int) -> Layout:
    if heads < 1 or c % heads or chp < c // heads:
        raise ValueError(f"no layout of C {c} in {heads} heads of {chp}")
    return Layout(c, heads, chp)


def flat_layout(c: int) -> Layout:
    """One head padded to a multiple of 16: the layout of the kernels that
    have no heads (K3, K4, K8)."""
    return Layout(c, 1, round16(c))


def pad_channels(t, lay: Layout, slots: int = 1, dim: int = -1):
    """``t`` with axis ``dim`` of ``slots`` x C channels (each slot in
    ``lay``'s heads) moved to ``slots`` x cp, zeros in the pads. None stays
    None."""
    if t is None or not lay.padded:
        return t
    dim %= t.dim()
    shape = t.shape
    parts = t.reshape(*shape[:dim], slots * lay.heads, lay.ch,
                      *shape[dim + 1:])
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, lay.chp - lay.ch]
    return F.pad(parts, pad).reshape(*shape[:dim], slots * lay.cp,
                                     *shape[dim + 1:])


def unpad_channels(t, lay: Layout, slots: int = 1, dim: int = -1):
    """The inverse of :func:`pad_channels`: the real channels of axis
    ``dim``, contiguous."""
    if not lay.padded:
        return t
    dim %= t.dim()
    shape = t.shape
    parts = t.reshape(*shape[:dim], slots * lay.heads, lay.chp,
                      *shape[dim + 1:])
    return parts.narrow(dim + 1, 0, lay.ch).reshape(
        *shape[:dim], slots * lay.c, *shape[dim + 1:]).contiguous()


def real_stats(gram, ss, lay: Layout):
    """The real ch x ch block of each head of a padded per-head Gram
    (B, heads, chp, chp), and the real channels of the padded sums of
    squares (B, 2, cp)."""
    if not lay.padded:
        return gram, ss
    return gram[..., :lay.ch, :lay.ch], unpad_channels(ss, lay)


def pad_square(m, lay: Layout):
    """A (B, C, C) matrix over the channels (A^T W_proj) in the padded
    space: (B, cp, cp) with zero rows and columns at the pads."""
    return pad_channels(pad_channels(m, lay, dim=-1), lay, dim=-2)
