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

``darkir``, ``hogformer``, ``transweather`` and ``mwformer_style`` are the
JAX package's recipes for models the port does not have yet (ROADMAP Queue
1 item 5): they raise ``NotImplementedError`` naming that model.
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


def default_recipe(loss_terms: Mapping[str, float],
                   aux_loss_weight: float = 0.0) -> LossFn:
    pixel = L.weighted_loss(dict(loss_terms))

    def fn(out, aux, batch):
        total, logs = pixel(_primary(out), batch["gt"])
        if aux_loss_weight and "aux_loss" in aux:
            total = total + aux_loss_weight * aux["aux_loss"]
            logs["aux"] = aux["aux_loss"]
        return total, logs

    return fn


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

    return fn


def _waits_for(recipe: str, model: str):
    def make(**kwargs):
        raise NotImplementedError(
            f"recipe {recipe!r} trains {model}, which the port does not have "
            f"yet (ROADMAP Queue 1 item 5)")

    return make


RECIPES: dict[str, Callable[..., LossFn]] = {
    "default": default_recipe,
    "nerd_rain": nerd_rain_recipe,
    "darkir": _waits_for("darkir", "DarkIR"),
    "hogformer": _waits_for("hogformer", "HOGformer"),
    "transweather": _waits_for("transweather", "TransWeather"),
    "mwformer_style": _waits_for("mwformer_style", "MWFormer's StyleFilter"),
}


def make_recipe(name: str, **kwargs) -> LossFn:
    if name not in RECIPES:
        raise KeyError(f"unknown recipe {name!r}; available: {sorted(RECIPES)}")
    return RECIPES[name](**kwargs)
