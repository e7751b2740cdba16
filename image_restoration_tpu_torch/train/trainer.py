"""Single training runtime for every model family
(image_restoration_tpu/train/trainer.py).

One train step for all families: the model's output is normalised by
:func:`split_model_output`, the named recipe (``train/recipes.py``) makes
the loss, autograd the gradients, and :class:`Optimizer` applies the JAX
package's optax chain. EMA is a parameter map updated in the step (BasicSR
model_ema, image_restoration_model.py:200-222).

On a mesh (``core/mesh.py``) each rank runs the step on its rows of the
global batch, and the step is the one-process step on the global batch,
as JAX's sharded jit is the one-device step partitioned
(``trainer.py:207-219``): the forward runs inside the step's
:class:`~image_restoration_tpu_torch.parallel.global_batch.GlobalBatch`
(BatchNorm statistics, the MoE balance sums and the routing noise are the
global batch's), a recipe of per-row means runs on the rank's rows and
its terms are averaged over the ranks, a batch-coupled recipe (SupCon)
sees the model's outputs gathered into the global batch, so every loss
term is the global one, and the gradient dict is summed over the data
axis, coalesced, before :meth:`Optimizer.update` (whose global-norm
clip then sees the global gradient). There is no DDP wrapper: DDP's
reducer hooks ``AccumulateGrad``, and the step takes its gradients with
``torch.autograd.grad``, which never runs those hooks. The ``expert`` and
``spatial`` axes only replicate, as JAX's step shards the batch over
``data`` alone.

The parameters live in the model and are updated in place, as are the
optimizer's moments: a step allocates no second copy of either.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainerConfig:
    learning_rate: Any = 2e-4              # float or step->lr schedule
    weight_decay: float = 0.0
    betas: tuple = (0.9, 0.999)
    grad_clip: Optional[float] = None       # max global norm (BasicSR uses 0.01)
    ema_decay: Optional[float] = None       # e.g. 0.999
    loss: Mapping[str, float] = dataclasses.field(default_factory=lambda: {"l1": 1.0})
    aux_loss_weight: float = 0.0            # MoE balance loss weight (MoCE: 0.01)
    optimizer: str = "adamw"
    recipe: str = "default"                 # named multi-output loss recipe
    recipe_kwargs: Mapping = dataclasses.field(default_factory=dict)
    apply_kwargs: Mapping = dataclasses.field(default_factory=dict)
    # extra keyword arguments of the model's forward at train time
    plateau: bool = False                   # host-driven LR scaling
    # (ReduceLROnPlateau, BasicSR train.py:285-293) through set_lr_scale
    accumulate_grad_batches: int = 1        # optax.MultiSteps micro-batching
    # (Lightning accumulate_grad_batches, MoCE-IR-main/src/train.py:128-135)
    freeze_prefixes: tuple = ()             # top-level param subtrees whose
    # updates are zeroed (MWFormer stage 2 freezes the trained style filter)


def _top_level(name: str) -> str:
    """The JAX tree's top-level key of a torch parameter name: its first
    segment, merged with a following index (``encoder_level1.0.x`` ->
    ``encoder_level1_0``), as ``utils/torch_import.py`` maps it."""
    segs = name.split(".")
    if len(segs) > 1 and segs[1].isdigit():
        return f"{segs[0]}_{segs[1]}"
    return segs[0]


class Optimizer:
    """``make_optimizer``'s optax chain (JAX ``trainer.py:67-100``), in its
    order: ``zero_nans`` and ``clip_by_global_norm`` (with ``grad_clip``),
    then adamw | adamw_hf (eps 1e-6) | adam | sgd (momentum 0.9), the
    plateau scale, the freeze mask last (so frozen parameters do not decay),
    all inside ``MultiSteps`` when ``accumulate_grad_batches`` > 1.

    Written out rather than built from ``torch.optim``, where torch's stock
    pieces differ from optax: ``clip_grad_norm_`` divides by norm + 1e-6,
    optax scales by max/norm only when norm > max (here one multiply by
    max/norm, in optax a divide by norm and a multiply by max: one rounding
    apart); ``zero_nans`` zeroes NaN and keeps inf; update n (counted from
    0, optax's count) takes ``learning_rate(n)``, where ``LambdaLR`` would
    be one step off; adamw decays by lr * wd * p of the pre-update p. The
    state is a dict of tensors and counters (``init``); ``update`` changes
    it in place and returns it.
    """

    def __init__(self, cfg: TrainerConfig):
        if cfg.optimizer not in ("adamw", "adamw_hf", "adam", "sgd"):
            raise KeyError(f"unknown optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        lr = cfg.learning_rate
        self.schedule = lr if callable(lr) else (lambda step: float(lr))
        self.eps = 1e-6 if cfg.optimizer == "adamw_hf" else 1e-8
        self.decay = (cfg.weight_decay if cfg.optimizer in ("adamw", "adamw_hf")
                      else 0.0)
        self.every_k = max(int(cfg.accumulate_grad_batches), 1)

    def frozen(self, name: str) -> bool:
        top = _top_level(name)
        return any(top == p or top.startswith(p)
                   for p in self.cfg.freeze_prefixes)

    def init(self, params: Mapping[str, Tensor]) -> Dict[str, Any]:
        def zeros():
            return {k: torch.zeros_like(p, memory_format=torch.preserve_format)
                    for k, p in params.items()}

        state: Dict[str, Any] = {"count": 0}
        if self.cfg.optimizer == "sgd":
            state["trace"] = zeros()
        else:
            state["mu"], state["nu"] = zeros(), zeros()
        if self.cfg.plateau:
            state["lr_scale"] = 1.0
        if self.every_k > 1:
            state["mini_step"] = 0
            state["acc"] = zeros()
        return state

    @torch.no_grad()
    def update(self, grads: Mapping[str, Tensor], state: Dict[str, Any],
               params: Mapping[str, Tensor]):
        """(updates, state): the updates to add to ``params``, keyed like
        them, or None on a micro-step of gradient accumulation (optax's
        zero updates)."""
        names = list(params)
        g = [grads[k] for k in names]
        if self.every_k > 1:
            # MultiSteps' running mean: acc + (g - acc) / (mini_step + 1)
            acc = [state["acc"][k] for k in names]
            diff = torch._foreach_sub(g, acc)
            torch._foreach_div_(diff, float(state["mini_step"] + 1))
            torch._foreach_add_(acc, diff)
            if state["mini_step"] < self.every_k - 1:
                state["mini_step"] += 1
                return None, state
            state["mini_step"] = 0
            g = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
        updates = self._inner(g, state, names, [params[k] for k in names])
        return dict(zip(names, updates)), state

    def _inner(self, g, state, names, p):
        cfg = self.cfg
        if cfg.grad_clip:
            g = [torch.where(torch.isnan(t), torch.zeros_like(t), t)
                 for t in g]
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            scale = torch.where(norm < cfg.grad_clip, torch.ones_like(norm),
                                cfg.grad_clip / norm)
            g = torch._foreach_mul(g, scale)
        n = state["count"]
        state["count"] = n + 1
        if cfg.optimizer == "sgd":
            trace = [state["trace"][k] for k in names]
            torch._foreach_mul_(trace, 0.9)
            torch._foreach_add_(trace, g)
            u = [t.clone() for t in trace]
        else:
            b1, b2 = cfg.betas
            mu = [state["mu"][k] for k in names]
            nu = [state["nu"][k] for k in names]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1 - b2)
            denom = torch._foreach_div(nu, 1 - b2 ** (n + 1))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            u = torch._foreach_div(mu, 1 - b1 ** (n + 1))
            torch._foreach_div_(u, denom)
            if self.decay:
                torch._foreach_add_(u, p, alpha=self.decay)
        torch._foreach_mul_(u, -self.schedule(n) * state.get("lr_scale", 1.0))
        for k, t in zip(names, u):
            if cfg.freeze_prefixes and self.frozen(k):
                t.zero_()
        return u


def make_optimizer(cfg: TrainerConfig) -> Optimizer:
    return Optimizer(cfg)


def set_lr_scale(opt_state: Dict[str, Any], scale: float):
    """Set the plateau scale of an optimizer state built with
    ``TrainerConfig(plateau=True)``; returns the state."""
    if "lr_scale" not in opt_state:
        raise ValueError("no plateau scale in opt_state — build the "
                         "optimizer with TrainerConfig(plateau=True)")
    opt_state["lr_scale"] = float(scale)
    return opt_state


@dataclasses.dataclass
class TrainState:
    """The step count, the model (which holds the parameters), the optimizer
    state and the EMA copy of the parameters (None without ``ema_decay``)."""

    step: int
    model: torch.nn.Module
    opt_state: Dict[str, Any]
    ema_params: Optional[Dict[str, Tensor]] = None

    @classmethod
    def create(cls, model, tx: Optimizer, ema_decay: Optional[float] = None):
        params = dict(model.named_parameters())
        ema = ({k: p.detach().clone() for k, p in params.items()}
               if ema_decay else None)
        return cls(step=0, model=model, opt_state=tx.init(params),
                   ema_params=ema)

    def state_dict(self) -> Dict[str, Any]:
        """``params`` is the model's state_dict; ``params_ema`` the same
        with the EMA parameters in place of the model's (buffers are the
        model's)."""
        out = {"step": self.step, "params": self.model.state_dict(),
               "opt_state": self.opt_state}
        if self.ema_params is not None:
            out["params_ema"] = {**out["params"], **self.ema_params}
        return out

    @torch.no_grad()
    def load_state_dict(self, d: Mapping[str, Any]):
        """Restore every tensor in place (on its current device)."""
        self.model.load_state_dict(d["params"])
        self.step = int(d["step"])
        _copy_into(self.opt_state, d["opt_state"])
        if self.ema_params is not None:
            for k, t in self.ema_params.items():
                t.copy_(d["params_ema"][k])
        return self


def _copy_into(dst: Dict[str, Any], src: Mapping[str, Any]):
    for k, v in src.items():
        if isinstance(v, Mapping):
            _copy_into(dst[k], v)
        elif isinstance(v, Tensor):
            dst[k].copy_(v)
        else:
            dst[k] = v


def split_model_output(out):
    """Normalize a model's return value to ``(out, aux_dict)``.

    ``(pred, {...})`` -> as-is; a tuple/list of tensors (NeRD-Rain's pyramid,
    model.py:603) stays whole with aux={}; a bare tensor gets aux={}.
    """
    if (isinstance(out, (tuple, list)) and len(out) == 2
            and isinstance(out[1], dict)):
        return out[0], out[1]
    return out, {}


def _gathered(value, gb):
    """The global batch of a model output or a batch entry, for a
    batch-coupled recipe: per-row tensors (dim 0 the rank's rows) gathered
    in the one-process order, tuples and dicts entry by entry; anything
    else (a scalar such as the balance loss, already global) as it is."""
    if isinstance(value, torch.Tensor):
        return (gb.gather(value) if value.dim() and value.shape[0] == gb.rows
                else value)
    if isinstance(value, (tuple, list)):
        return type(value)(_gathered(v, gb) for v in value)
    if isinstance(value, dict):
        return {k: _gathered(v, gb) for k, v in value.items()}
    return value


def _global_logs(logs, gb):
    """The global values of a per-row recipe's logs (``total`` among them):
    each rank's means averaged over the data ranks (one all-reduce; no
    gradient)."""
    from image_restoration_tpu_torch.parallel.comm import all_reduce_

    keys, device = list(logs), logs["total"].device
    flat = torch.stack([torch.as_tensor(logs[k], device=device).detach()
                        .float() for k in keys])
    flat = all_reduce_(flat, gb.group) / gb.size
    return dict(zip(keys, flat.unbind()))


def reduce_gradients(grads: Dict[str, Tensor], group) -> Dict[str, Tensor]:
    """Sums the gradient dict over ``group`` in place, one flat buffer a
    dtype (coalesced); returns it."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    from image_restoration_tpu_torch.parallel.comm import all_reduce_

    by_dtype: Dict[Any, list] = {}
    for k, g in grads.items():
        by_dtype.setdefault(g.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = all_reduce_(_flatten_dense_tensors([grads[k] for k in keys]),
                           group)
        for k, g in zip(keys, _unflatten_dense_tensors(
                flat, [grads[k] for k in keys])):
            grads[k] = g
    return grads


def loss_and_grads(model, recipe, batch, apply_kwargs=None, params=None,
                   gb=None):
    """(logs, grads) of one batch: the recipe's terms and their ``total``,
    and d total / d param for every parameter (zeros where the loss does
    not reach one, as ``jax.grad`` gives).

    With ``gb`` (a :class:`GlobalBatch`) ``batch`` holds this rank's rows
    and the forward runs inside ``gb``. A recipe that is a mean of per-row
    terms (``per_row``, ``train/recipes.py``) runs on the rank's rows: its
    total, averaged over the data ranks, is the global loss. Any other
    recipe sees the outputs and the batch gathered into the global batch
    and computes the global loss on every rank. Either way this rank
    differentiates its share (total / data size), the gradients are summed
    over the data ranks, and ``logs`` are the global values."""
    from image_restoration_tpu_torch.parallel import global_batch

    params = dict(model.named_parameters()) if params is None else params
    with global_batch.using(gb):
        out = model(batch["lq"], **dict(apply_kwargs or {}))
    out, aux = split_model_output(out)
    per_row = getattr(recipe, "per_row", False)
    if gb is not None and not per_row:  # the recipes read the targets
        out, aux, batch = (_gathered(out, gb), _gathered(aux, gb),
                           _gathered({k: v for k, v in batch.items()
                                      if k != "lq"}, gb))
    total, logs = recipe(out, aux, batch)
    share = total if gb is None else total / gb.size
    if gb is not None and per_row:
        logs = _global_logs({**logs, "total": total}, gb)
        total = logs.pop("total")
    grads = torch.autograd.grad(share, list(params.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    if gb is not None:
        reduce_gradients(grads, gb.group)
    logs["total"] = total
    return logs, grads


def apply_updates(state: TrainState, params, updates, ema_decay) -> None:
    """Adds ``updates`` (None on a micro-batch that does not step) to
    ``params`` in place, then ticks the state's EMA, when it has one and
    ``ema_decay`` is set: ``decay * ema + (1 - decay) * params``. The EMA
    thus ticks once per OPTIMIZER step, not per micro-batch."""
    if updates is None:
        return
    plist = list(params.values())
    with torch.no_grad():
        torch._foreach_add_(plist, list(updates.values()))
        if state.ema_params is not None and ema_decay:
            ema = [state.ema_params[k] for k in params]
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, plist, alpha=1 - ema_decay)


def step_global_batch(mesh, rows: int):
    """The :class:`GlobalBatch` of a step on ``mesh`` whose rank holds
    ``rows`` rows: the data axis's group, size and this rank's index; None
    without a mesh."""
    if mesh is None:
        return None
    from image_restoration_tpu_torch.core.mesh import axis_index, axis_size
    from image_restoration_tpu_torch.parallel.global_batch import GlobalBatch

    return GlobalBatch(mesh.get_group("data"), axis_size(mesh, "data"),
                       axis_index(mesh, "data"), rows)


def make_train_step(model, tx: Optimizer, cfg: TrainerConfig,
                    mesh=None) -> Callable:
    """The train step ``(state, batch[, generator]) -> (state, logs)``.

    The model's forward may return ``pred``, ``(pred, aux)`` with ``aux`` a
    dict (``aux_loss``, side heads), or a tuple of tensors (NeRD-Rain's
    7-output pyramid). ``batch``: dict with 'lq' (degraded) and 'gt', NCHW,
    on the model's device. The model is put in ``train()`` mode. ``logs``
    are 0-d tensors, detached: a step reads nothing back to the host, so
    the host runs ahead of the card unless the caller logs.

    ``step_fn(state, batch, generator)``: a ``torch.Generator`` on the
    model's device is passed to the forward as ``generator`` (the MoE
    families' routing noise under ``apply_kwargs`` ``{"train": True}``; the
    JAX step's ``rngs={"moe": rng}``); None passes nothing.

    On ``mesh`` (a ``DeviceMesh`` with a ``data`` axis) ``batch`` is this
    rank's rows of the global batch, and the generator the one the
    one-process step would take: the step is the one-process step on the
    global batch (module docstring); every rank ends it with the same
    parameters, optimizer state and logs.
    """
    from image_restoration_tpu_torch.train.recipes import make_recipe

    if cfg.recipe == "default" and not cfg.recipe_kwargs:
        recipe = make_recipe("default", loss_terms=cfg.loss,
                             aux_loss_weight=cfg.aux_loss_weight)
    else:
        recipe = make_recipe(cfg.recipe, **dict(cfg.recipe_kwargs))
    apply_kwargs = dict(cfg.apply_kwargs)
    params = dict(model.named_parameters())

    def step_fn(state: TrainState, batch, generator=None):
        model.train()
        kwargs = (apply_kwargs if generator is None
                  else {**apply_kwargs, "generator": generator})
        gb = step_global_batch(mesh, batch["lq"].shape[0])
        logs, grads = loss_and_grads(model, recipe, batch, kwargs, params,
                                     gb)
        updates, state.opt_state = tx.update(grads, state.opt_state, params)
        apply_updates(state, params, updates, cfg.ema_decay)
        state.step += 1
        return state, {k: v.detach() for k, v in logs.items()}

    return step_fn


def make_eval_step(model, use_ema: bool = False) -> Callable:
    """``(state, lq) -> restored`` in [0, 1]: the model in eval mode (the
    EMA parameters when ``use_ema`` and the state has them) under
    ``torch.inference_mode()`` with TF32 off (``utils/precision.py``
    ``full_fp32``), as the JAX step runs under "highest"
    (``trainer.py:221-231``); a tuple output gives its first element. The
    model's mode is restored after the call."""
    from image_restoration_tpu_torch.utils.precision import full_fp32

    def eval_fn(state: TrainState, lq):
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode(), full_fp32():
                if use_ema and state.ema_params is not None:
                    out = torch.func.functional_call(model, state.ema_params,
                                                     (lq,))
                else:
                    out = model(lq)
        finally:
            model.train(was_training)
        if isinstance(out, tuple):
            out = out[0]
        return torch.clamp(out, 0.0, 1.0)

    return eval_fn
