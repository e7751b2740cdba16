"""Whole-image tiled inference (image_restoration_tpu/eval/tiled.py, which
is NHWC; these take (B, C, H, W) tensors).

The reference's throughput-benchmark path (NeRD-Rain test.py:45-63) splits an
arbitrary HxW image into non-overlapping ws x ws windows, with remainder rows/
columns covered by *edge-aligned* extra windows (right column, bottom row,
corner — layers.py:249-272), runs the batch through the net, and writes
windows back with edge windows only contributing their non-overlapping strip
(layers.py:274-304). The placement is the JAX package's, and all windows go
through the model as ONE batch (or chunks of ``max_batch``).

Also here: ``pad_test`` (pad-to-multiple whole-image eval,
basicsr image_restoration_model.py:326-338) and overlap-chop
(IPT forward_chop shave-and-blend, AdaptIR-main/net/ipt.py:115-248).
"""

from __future__ import annotations

import torch

from image_restoration_tpu_torch.ops.common import crop_to, pad_to_multiple


def _grid_starts(size: int, ws: int):
    """Main-grid starts plus an edge-aligned remainder start (static)."""
    starts = list(range(0, (size // ws) * ws, ws))
    has_rem = size % ws != 0
    return starts, has_rem


def window_partition(x, ws: int):
    """(B, C, H, W) -> (B*nwin, C, ws, ws) with reference window placement.

    Order: main grid (row-major), then right-column windows, bottom-row
    windows, corner window; window-major, batch-minor (window k of image i
    is row ``k*B + i``), as the JAX ``window_reverse`` reads them back.
    """
    b, c, h, w = x.shape
    hs, hrem = _grid_starts(h, ws)
    vs, wrem = _grid_starts(w, ws)

    tiles = []
    for i in hs:
        for j in vs:
            tiles.append(x[:, :, i : i + ws, j : j + ws])
    n_main = len(tiles)
    if wrem:
        for i in hs:
            tiles.append(x[:, :, i : i + ws, w - ws :])
    n_right = len(tiles)
    if hrem:
        for j in vs:
            tiles.append(x[:, :, h - ws :, j : j + ws])
    n_bottom = len(tiles)
    if hrem and wrem:
        tiles.append(x[:, :, h - ws :, w - ws :])

    out = torch.cat(tiles, dim=0)
    meta = dict(b=b, h=h, w=w, c=c, ws=ws, n_main=n_main, n_right=n_right,
                n_bottom=n_bottom, hs=hs, vs=vs, hrem=hrem, wrem=wrem)
    return out, meta


def window_reverse(windows, meta):
    """Inverse of window_partition; edge windows overwrite only their
    non-overlapping strip (layers.py:274-304 semantics)."""
    b, h, w, ws = meta["b"], meta["h"], meta["w"], meta["ws"]
    hs, vs = meta["hs"], meta["vs"]
    c = windows.shape[1]
    out = windows.new_zeros((b, c, h, w))
    rem_h = h - (h // ws) * ws
    rem_w = w - (w // ws) * ws

    idx = 0
    for i in hs:
        for j in vs:
            out[:, :, i : i + ws, j : j + ws] = windows[idx * b : (idx + 1) * b]
            idx += 1
    if meta["wrem"]:
        for i in hs:
            tile = windows[idx * b : (idx + 1) * b]
            out[:, :, i : i + ws, w - rem_w :] = tile[:, :, :, ws - rem_w :]
            idx += 1
    if meta["hrem"]:
        for j in vs:
            tile = windows[idx * b : (idx + 1) * b]
            out[:, :, h - rem_h :, j : j + ws] = tile[:, :, ws - rem_h :, :]
            idx += 1
    if meta["hrem"] and meta["wrem"]:
        tile = windows[idx * b : (idx + 1) * b]
        out[:, :, h - rem_h :, w - rem_w :] = tile[:, :, ws - rem_h :,
                                                   ws - rem_w :]
    return out


def windowed_apply(fn, x, ws: int, max_batch: int | None = None):
    """Run ``fn`` over all windows of ``x`` as one batch (or chunks of
    ``max_batch`` to bound activation memory) and reassemble."""
    wins, meta = window_partition(x, ws)
    if max_batch is None or wins.shape[0] <= max_batch:
        outs = fn(wins)
    else:
        outs = torch.cat([fn(wins[s : s + max_batch])
                          for s in range(0, wins.shape[0], max_batch)], dim=0)
    return window_reverse(outs, meta)


def pad_test(fn, x, multiple: int, mode: str = "reflect", scale: int = 1):
    """Pad an NCHW batch to a multiple, run ``fn``, crop back
    (image_restoration_model.py:326-338). ``scale`` > 1 for SR models whose
    output is scale-x larger: the crop keeps (H*scale, W*scale)."""
    xp, hw = pad_to_multiple(x, multiple, mode)
    out = fn(xp)
    return crop_to(out, (hw[0] * scale, hw[1] * scale))


def overlap_average_apply(fn, x, patch: int = 48, stride: int | None = None,
                          scale: int = 1, max_batch: int | None = None):
    """IPT dense-stride tiling (AdaptIR-main/net/ipt.py:115-248): patches of
    size ``patch`` at stride ``shave/2`` (default patch/4), batched through
    ``fn``, recombined by overlap-add with a fold/unfold divisor — every
    output pixel is the average of all patches covering it. The reference
    additionally gives border strips priority over the average; interior
    math is identical. The sums accumulate in the output's dtype, as in the
    JAX package.
    """
    b, c, h, w = x.shape
    stride = stride or patch // 4

    def starts(size):
        s = list(range(0, size - patch + 1, stride))
        if not s or s[-1] != size - patch:
            s.append(size - patch)
        return s

    hs, vs = starts(h), starts(w)
    tiles = [x[:, :, i : i + patch, j : j + patch] for i in hs for j in vs]
    wins = torch.cat(tiles, dim=0)
    if max_batch is None or wins.shape[0] <= max_batch:
        outs = fn(wins)
    else:
        outs = torch.cat([fn(wins[s : s + max_batch])
                          for s in range(0, wins.shape[0], max_batch)], dim=0)
    ps = patch * scale
    acc = outs.new_zeros((b, outs.shape[1], h * scale, w * scale))
    cnt = outs.new_zeros((1, 1, h * scale, w * scale))
    idx = 0
    for i in hs:
        for j in vs:
            t = outs[idx * b : (idx + 1) * b]
            acc[:, :, i * scale : i * scale + ps,
                j * scale : j * scale + ps] += t
            cnt[:, :, i * scale : i * scale + ps,
                j * scale : j * scale + ps] += 1.0
            idx += 1
    return acc / cnt


def chop_apply(fn, x, min_size: int = 160 * 160, shave: int = 12,
               scale: int = 1):
    """IPT forward_chop (AdaptIR-main/net/ipt.py:115-248): recursively split
    into 4 overlapping quadrants until each fits min_size, forward, and
    paste the un-shaved interiors."""
    b, c, h, w = x.shape
    if h * w <= min_size:
        return fn(x)
    h_half, w_half = h // 2, w // 2
    h_size, w_size = h_half + shave, w_half + shave
    quads = [
        x[:, :, :h_size, :w_size],
        x[:, :, :h_size, w - w_size :],
        x[:, :, h - h_size :, :w_size],
        x[:, :, h - h_size :, w - w_size :],
    ]
    outs = [chop_apply(fn, q, min_size, shave, scale) for q in quads]
    h_out, w_out = h * scale, w * scale
    hh, wh = h_half * scale, w_half * scale
    hsz, wsz = h_size * scale, w_size * scale
    out = outs[0].new_zeros((b, outs[0].shape[1], h_out, w_out))
    out[:, :, :hh, :wh] = outs[0][:, :, :hh, :wh]
    out[:, :, :hh, wh:] = outs[1][:, :, :hh, wsz - (w_out - wh) :]
    out[:, :, hh:, :wh] = outs[2][:, :, hsz - (h_out - hh) :, :wh]
    out[:, :, hh:, wh:] = outs[3][:, :, hsz - (h_out - hh) :,
                                  wsz - (w_out - wh) :]
    return out
