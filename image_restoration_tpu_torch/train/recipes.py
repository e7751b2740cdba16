"""Named training-loss recipes (image_restoration_tpu/train/recipes.py).

A recipe is ``fn(out, aux, batch) -> (total, logs)`` where ``out`` is the
model's primary output (a tensor, or a tuple of tensors for multi-scale
models), ``aux`` is the model's auxiliary dict ({} when absent), and
``batch`` has 'lq'/'gt' NCHW tensors.

* ``default``    — weighted pixel losses on the primary output, plus the MoE
                   balance term from ``aux['aux_loss']`` (Lightning recipe,
                   MoCE-IR-main/src/train.py:64-71).
* ``nerd_rain``  — 3-level Gaussian-pyramid supervision:
                   Charbonnier + 0.01*FFT + 0.05*Edge per scale, plus
                   0.1 * L1 on the two INR intermediate outputs vs pyramid
                   levels 1/2 (NeRD-Rain-main/train.py:155-163; output order
                   out[0..2]=max/mid/small, out[3]=INR-mid, out[5]=INR-small).

* ``darkir``     — pixel losses on the primary output + EnhanceLoss on the
                   bottleneck side head: criterion(nearest_up(side, 8), gt)
                   (DarkIR-main/losses/loss.py:502-529; the VGG19
                   perceptual term is omitted, as in JAX, and its hook is
                   ``vgg_term``).
* ``transweather`` — smooth_l1 + 0.04 * VGG16 perceptual
                   (TransWeather-main/train.py:161-164): relu1_2/2_2/3_3
                   feature MSE of ``vgg``, an ``eval/perceptual.py``
                   ``VGG16Features`` (a torchvision vgg16's weights, or a
                   random init), frozen.
* ``hogformer``  — L1 + (1-pearson)/2 + HOG-MSE
                   (image_restoration_model.py:303-311: l_pix + l_pear +
                   l_hog; (1-rho)/2 == 0.5 * pearson_loss exactly).
* ``mwformer_style`` — stage-1 SupCon over StyleFilter embeddings
                   (MWFormer/main_train_style.py:1-75: the 64-d style
                   vector trained contrastively against the degradation
                   labels, then frozen for restoration training). The
                   model's output is the (B, 64) embedding; the labels ride
                   ``batch['de_id']``.

Every recipe but ``mwformer_style`` is a mean of per-row terms over rows of
one size (so is every loss of ``train/losses.py`` but the two contrastive
ones), and says so by ``fn.per_row = True`` (:func:`_per_row`): a
data-parallel step (``train/trainer.py``) runs such a recipe on each rank's
rows and averages over the ranks. A batch-coupled recipe (SupCon's pairs
across the batch) sees the gathered global batch instead.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

from image_restoration_tpu_torch.train import losses as L

LossFn = Callable[[Any, Mapping, Mapping], tuple]


def _primary(out):
    """First tensor output of a multi-output model; identity otherwise."""
    if isinstance(out, (tuple, list)):
        return out[0]
    return out


def _per_row(fn, per_row: bool = True):
    """Marks recipe ``fn`` as a mean of per-row terms (module docstring)."""
    fn.per_row = per_row
    return fn


def default_recipe(loss_terms: Mapping[str, float],
                   aux_loss_weight: float = 0.0) -> LossFn:
    pixel = L.weighted_loss(dict(loss_terms))

    def fn(out, aux, batch):
        total, logs = pixel(_primary(out), batch["gt"])
        if aux_loss_weight and "aux_loss" in aux:
            total = total + aux_loss_weight * aux["aux_loss"]
            logs["aux"] = aux["aux_loss"]
        return total, logs

    return _per_row(fn)


def nerd_rain_recipe(char_w: float = 1.0, fft_w: float = 0.01,
                     edge_w: float = 0.05, inr_w: float = 0.1) -> LossFn:
    def fn(out, aux, batch):
        pyr = L.build_pyramid(batch["gt"], 3)
        scales = out[:3]
        char = sum(L.charbonnier_loss(o, t) for o, t in zip(scales, pyr))
        fft = sum(L.fft_abs_loss(o, t) for o, t in zip(scales, pyr))
        edge = sum(L.edge_loss(o, t) for o, t in zip(scales, pyr))
        inr = L.l1_loss(out[3], pyr[1]) + L.l1_loss(out[5], pyr[2])
        total = char_w * char + fft_w * fft + edge_w * edge + inr_w * inr
        return total, {"char": char, "fft": fft, "edge": edge, "inr_l1": inr}

    return _per_row(fn)


def _nearest_up(x, scale: int):
    """torch F.interpolate(mode='nearest', scale_factor=s) of NCHW."""
    return x.repeat_interleave(scale, dim=2).repeat_interleave(scale, dim=3)


def darkir_recipe(loss_terms: Mapping[str, float] | None = None,
                  enhance_weight: float = 1.0, side_scale: int = 8,
                  criterion: str = "l1", vgg_term: LossFn | None = None) -> LossFn:
    """DarkIR mid-supervision: the side head (the 1/8-size bottleneck
    projection, DarkIR.py:70-72,90-91) nearest-upsampled x8 against the GT
    (losses/loss.py:527-529). ``vgg_term(up_side, gt)`` adds a perceptual
    part."""
    pixel = L.weighted_loss(dict(loss_terms or {"l1": 1.0}))
    crit = L.l1_loss if criterion == "l1" else L.mse_loss

    def fn(out, aux, batch):
        total, logs = pixel(_primary(out), batch["gt"])
        if aux.get("side") is not None:
            up = _nearest_up(aux["side"], side_scale)
            enh = crit(up, batch["gt"])
            if vgg_term is not None:
                enh = enh + vgg_term(up, batch["gt"])
            total = total + enhance_weight * enh
            logs["enhance"] = enh
        return total, logs

    return _per_row(fn, vgg_term is None)  # vgg_term: the caller's callable


def transweather_recipe(vgg=None, perceptual_w: float = 0.04,
                        beta: float = 1.0) -> LossFn:
    """smooth_l1 + 0.04 * perceptual (TransWeather-main/train.py:161-164).

    ``vgg``: an ``eval/perceptual.py`` ``VGG16Features`` at the
    relu1_2/2_2/3_3 taps, put in eval mode and frozen here. Without it the
    recipe is smooth_l1 alone, as in JAX."""
    from image_restoration_tpu_torch.eval.perceptual import perceptual_loss

    if vgg is not None:
        vgg.eval().requires_grad_(False)

    def fn(out, aux, batch):
        pred, gt = _primary(out), batch["gt"]
        sl1 = L.smooth_l1_loss(pred, gt, beta=beta)
        logs = {"smooth_l1": sl1}
        total = sl1
        if vgg is not None:
            perc = perceptual_loss(vgg, pred, gt, criterion="mse")
            total = total + perceptual_w * perc
            logs["perceptual"] = perc
        return total, logs

    return _per_row(fn)


def hogformer_recipe(pix_w: float = 1.0, pearson_w: float = 0.5,
                     hog_w: float = 1.0) -> LossFn:
    def fn(out, aux, batch):
        pred, gt = _primary(out), batch["gt"]
        l_pix = L.l1_loss(pred, gt)
        l_pear = pearson_w * L.pearson_loss(pred, gt)   # == (1-rho)/2 at 0.5
        l_hog = L.hog_loss(pred, gt)
        total = pix_w * l_pix + l_pear + hog_w * l_hog
        return total, {"l_pix": l_pix, "l_pear": l_pear, "l_hog": l_hog}

    return _per_row(fn)


def mwformer_style_recipe(temperature: float = 0.1) -> LossFn:
    """Stage-1 style training: SupCon over the StyleFilter's 64-d
    embeddings (in fp32) with the degradation id as the label
    (MWFormer/main_train_style.py:1-75). Use with ``--model
    mwformer_style``; stage 2 then loads and freezes the trained filter
    inside the full MWFormer (``cli/train.py --style_ckpt``)."""

    def fn(out, aux, batch):
        emb = _primary(out).float()
        loss = L.supcon_loss(emb, batch["de_id"], temperature=temperature)
        return loss, {"supcon": loss}

    return _per_row(fn, False)


RECIPES: dict[str, Callable[..., LossFn]] = {
    "default": default_recipe,
    "nerd_rain": nerd_rain_recipe,
    "darkir": darkir_recipe,
    "hogformer": hogformer_recipe,
    "transweather": transweather_recipe,
    "mwformer_style": mwformer_style_recipe,
}


def make_recipe(name: str, **kwargs) -> LossFn:
    if name not in RECIPES:
        raise KeyError(f"unknown recipe {name!r}; available: {sorted(RECIPES)}")
    return RECIPES[name](**kwargs)
