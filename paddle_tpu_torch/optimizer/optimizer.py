"""Optimizers: the functional updates, the eager ``step()`` and the fused
flat Adam/AdamW path.

Port of ``paddle_tpu/optimizer/optimizer.py``.  Every optimizer has two
execution modes, as in the JAX package, over one update rule
(``_update``):

- **functional**: ``init_state(params)`` and ``apply(params, grads, state,
  lr, step, decay_mask=None, regularizers=None)`` over ``{name: tensor}``
  dicts, which the train step (``models/llama.py``) calls; Adam/AdamW
  also have the fused flat path, ``init_flat_state`` and ``apply_flat``,
  over flat fp32 buffers, one per (decay?, dtype) group with the JAX
  package's group names, e.g. ``decay|bfloat16``.  These return new
  tensors and leave their inputs untouched;
- **eager**: ``Optimizer(parameters=[...])`` over ``torch.nn.Parameter``s
  whose ``.grad`` autograd filled; ``step()`` updates each parameter in
  place under ``torch.no_grad()``.  A parameter with
  ``requires_grad=False`` or no gradient is left alone.  Attributes set on
  a parameter steer it as in Paddle: ``no_weight_decay`` (no decay of any
  kind), ``regularizer`` (a ``regularizer.L1Decay``/``L2Decay`` that
  replaces the optimizer's decay) and ``need_clip`` (read by
  ``ClipGradByGlobalNorm``).  ``parameters`` may hold the (name,
  parameter) pairs of ``named_parameters()``: the names are what AdamW's
  ``apply_decay_param_fun`` reads (a tensor's own ``name`` attribute is
  read-only in PyTorch).

``learning_rate`` is a float or an ``lr.LRScheduler``; ``weight_decay`` a
float or a regularizer instance; ``grad_clip`` a clip of
``optimizer/clip.py``, applied by the eager ``step()`` (the functional
train step does not clip, as in the JAX package).  The update is plain
elementwise PyTorch, as the JAX package left it to XLA.

On a mesh (``models/llama.py``'s mesh step) the params and grads are
``parallel.specs.ShardedTensor`` blocks.  ``init_state`` then keeps each
moment as a block of its parameter's placement; the flat path takes the
schedule's ``FlatUpdateLayout`` (``flat_layout=``): a group whose every
leaf decomposes keeps this rank's block of the shard-major buffers and its
name carries the layout's signature (``decay|float32|sm[dp2.mp2]``); any
other group keeps the row-major buffers whole on every rank.  Given plain
tensors, a layout's groups are the global shard-major buffers, element for
element the JAX package's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from ..regularizer import WeightDecayRegularizer
from . import lr as lr_mod


def _pin_lr_f32(lr):
    """Mirror of ``_pin_lr_f32``: a float64 tensor lr becomes float32 so it
    cannot promote the update chain; Python floats pass unchanged."""
    if isinstance(lr, torch.Tensor) and lr.dtype == torch.float64:
        return lr.to(torch.float32)
    return lr


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]           # torch.bfloat16 -> bfloat16


def _check_layout(flat_layout):
    """``flat_layout`` is None or a ``FlatUpdateLayout``; one with no
    parallel axis has nothing to cut (its order is row-major) and counts as
    None, as in the JAX package."""
    if flat_layout is None:
        return None
    from ..parallel.schedule import FlatUpdateLayout

    if not isinstance(flat_layout, FlatUpdateLayout):
        raise TypeError(f"flat_layout= takes a parallel.schedule."
                        f"FlatUpdateLayout, got {type(flat_layout).__name__}")
    return flat_layout if flat_layout.axes else None


def _sharded(values) -> bool:
    from ..parallel.specs import ShardedTensor

    return any(isinstance(v, ShardedTensor) for v in values)


def _f32(value: torch.Tensor) -> torch.Tensor:
    return value.to(torch.float32)


def _zeros32(value: torch.Tensor) -> torch.Tensor:
    return torch.zeros(value.shape, dtype=torch.float32, device=value.device)


def _scalar32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


class Optimizer:
    """Base of every optimizer (mirror of ``Optimizer``): the learning rate,
    the decay (a float or a regularizer instance), the clip, the
    functional ``apply`` and the eager ``step``.  Subclasses define
    ``init_param_state`` and ``_update(value, grad, state, lr, step, wd)
    -> (new_value, new_state)``, with ``wd`` the float weight decay that
    applies to this parameter."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._lr = learning_rate
        self._parameters, self._names = [], {}
        for p in parameters if parameters is not None else ():
            if isinstance(p, tuple):
                self._names[id(p[1])] = p[0]
                p = p[1]
            self._parameters.append(p)
        # a regularizer instance stays one: a per-parameter regularizer
        # replaces it, so it must not fold into the float weight decay
        self._regularizer = None
        if isinstance(weight_decay, WeightDecayRegularizer):
            self._regularizer = weight_decay
            weight_decay = None
        self._weight_decay = 0.0 if weight_decay is None \
            else float(weight_decay)
        self._grad_clip = grad_clip
        self._state: Dict[int, Dict[str, Any]] = {}   # id(param) -> state
        self._global_step = 0

    # ---- learning rate

    def get_lr(self) -> float:
        if isinstance(self._lr, lr_mod.LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, lr) -> None:
        self._lr = lr

    # ---- functional core

    def init_param_state(self, value) -> Dict[str, Any]:
        return {}

    def update(self, value, grad, state, lr, step: int):
        """Pure single-tensor update with the optimizer's own weight decay:
        returns (new_value, new_state)."""
        return self._update(value, grad, state, lr, step, self._weight_decay)

    def _update(self, value, grad, state, lr, step, wd):
        raise NotImplementedError

    def init_state(self, params: Dict[str, torch.Tensor]):
        """Per-parameter state; a ``ShardedTensor`` parameter gets its state
        as blocks of the same placement."""
        out = {}
        for k, v in params.items():
            if _sharded([v]):
                out[k] = {n: v.with_local(t) for n, t in
                          self.init_param_state(v.local).items()}
            else:
                out[k] = self.init_param_state(v)
        return out

    def apply(self, params, grads, state, lr, step: int = 0,
              decay_mask: Optional[Dict[str, bool]] = None,
              regularizers: Optional[Dict[str, WeightDecayRegularizer]] = None):
        """Per-tensor update; returns (new_params, new_state).  A parameter
        masked out of ``decay_mask`` gets no decay of any kind;
        ``regularizers`` maps names to per-parameter regularizers, which
        replace both the optimizer-level regularizer and its float weight
        decay (the eager path's precedence).  A parameter without a
        gradient passes through; every new value keeps its dtype."""
        lr = _pin_lr_f32(lr)
        new_params, new_state = {}, {}
        for k, v in params.items():
            g = grads.get(k)
            if g is None:
                new_params[k] = v
                new_state[k] = state.get(k, {})
                continue
            masked = decay_mask is not None and not decay_mask.get(k, True)
            has_override = regularizers is not None and k in regularizers
            reg = regularizers[k] if has_override else self._regularizer
            if reg is not None and not masked:
                g = g + reg._apply(v).to(g.dtype)
            wd = 0.0 if masked or has_override else self._weight_decay
            st = state.get(k) or self.init_param_state(v)
            nv, ns = self._update(v, g, st, lr, step, wd)
            new_params[k] = nv.to(v.dtype)
            new_state[k] = ns
        return new_params, new_state

    # ---- eager path

    def _param_lr(self, p, lr: float) -> float:
        return lr

    def param_name(self, p) -> str:
        """The name ``p`` was given with (``named_parameters()``), else
        ''."""
        return self._names.get(id(p), "")

    @torch.no_grad()
    def step(self):
        """One update of every parameter from its ``.grad``, in place
        (mirror of ``Optimizer.step``): the clip first, then per parameter
        its regularizer (or the optimizer's), its weight decay unless
        ``no_weight_decay`` or a per-parameter regularizer says otherwise,
        and its learning rate (``lr_ratio``)."""
        self._global_step += 1
        params = self._parameters
        grads = [p.grad for p in params]
        if self._grad_clip is not None:
            grads = self._grad_clip(params, grads)
        lr = self.get_lr()
        for p, g in zip(params, grads):
            if g is None or not p.requires_grad:
                continue
            value = p.detach()
            st = self._state.get(id(p))
            if st is None:
                st = self.init_param_state(value)
            no_decay = getattr(p, "no_weight_decay", False)
            param_reg = getattr(p, "regularizer", None)
            reg = param_reg if param_reg is not None else self._regularizer
            if reg is not None and not no_decay:
                g = g + reg._apply(value).to(g.dtype)
            wd = 0.0 if no_decay or param_reg is not None \
                else self._weight_decay
            new_v, new_s = self._update(value, g.to(value.dtype), st,
                                        self._param_lr(p, lr),
                                        self._global_step, wd)
            p.copy_(new_v)
            self._state[id(p)] = new_s

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._parameters:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    # ---- state dict

    def state_dict(self) -> Dict[str, Any]:
        """``global_step``, the scheduler's state under ``LR_Scheduler``,
        and each parameter's state as ``param{i}.{key}`` (i its index in
        ``parameters``)."""
        out: Dict[str, Any] = {"global_step": self._global_step}
        if isinstance(self._lr, lr_mod.LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        for i, p in enumerate(self._parameters):
            for k, v in (self._state.get(id(p)) or {}).items():
                out[f"param{i}.{k}"] = v
        return out

    def set_state_dict(self, state: Dict[str, Any]) -> None:
        self._global_step = state.get("global_step", 0)
        if "LR_Scheduler" in state and isinstance(self._lr,
                                                  lr_mod.LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])
        for i, p in enumerate(self._parameters):
            prefix = f"param{i}."
            st = {k[len(prefix):]: torch.as_tensor(v)
                  for k, v in state.items()
                  if isinstance(k, str) and k.startswith(prefix)}
            if st:
                self._state[id(p)] = st


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _update(self, value, grad, state, lr, step, wd):
        if wd:
            grad = grad + wd * value
        return value - lr * grad, state


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def init_param_state(self, value):
        return {"velocity": torch.zeros_like(value)}

    def _update(self, value, grad, state, lr, step, wd):
        if wd:
            grad = grad + wd * value
        v = self._momentum * state["velocity"] + grad
        if self._nesterov:
            return value - lr * (grad + self._momentum * v), {"velocity": v}
        return value - lr * v, {"velocity": v}


class Adam(Optimizer):
    """Mirror of ``Adam``: L2 weight decay coupled into the gradient, fp32
    moments, and with ``multi_precision`` an fp32 master for every non-fp32
    parameter.  ``lazy_mode`` is accepted and ignored, as in the JAX
    package (every row of a dense gradient updates)."""

    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon
        self._multi_precision = multi_precision

    def init_param_state(self, value):
        st = {"moment1": _zeros32(value), "moment2": _zeros32(value)}
        if self._multi_precision and value.dtype != torch.float32:
            st["master"] = value.float()
        return st

    def _math(self, g, m1, m2, master, lr, step, wd):
        """The elementwise Adam/AdamW step shared by ``_update`` and the
        flat groups (``_flat_group_update``): returns (master, m1, m2)."""
        if wd and not self._decoupled:
            g = g + wd * master
        nm1 = self._beta1 * m1 + (1 - self._beta1) * g
        nm2 = self._beta2 * m2 + (1 - self._beta2) * torch.square(g)
        bc1 = 1 - self._beta1 ** step
        bc2 = 1 - self._beta2 ** step
        upd = (nm1 / bc1) / (torch.sqrt(nm2 / bc2) + self._eps)
        if wd and self._decoupled:
            upd = upd + wd * master
        return master - lr * upd, nm1, nm2

    def _update(self, value, grad, state, lr, step, wd):
        master = state.get("master", value.float())
        new_master, m1, m2 = self._math(grad.float(), state["moment1"],
                                        state["moment2"], master, lr, step,
                                        wd)
        new_state = {"moment1": m1, "moment2": m2}
        if "master" in state or (self._multi_precision
                                 and value.dtype != torch.float32):
            new_state["master"] = new_master
        return new_master.to(value.dtype), new_state

    # ---- fused multi-tensor (flat) path

    def _flat_groups(self, params, decay_mask=None, flat_layout=None
                     ) -> List[Dict[str, Any]]:
        """Mirror of ``_flat_groups``: float params grouped by (decay?,
        dtype), keys sorted, so init and every apply agree.  Under a
        ``flat_layout`` a group whose every leaf has a shard-major plan gains
        ``layout``/``plans`` and the layout's signature in its name; a group
        with any other leaf stays row-major.  Shapes are global (a
        ``ShardedTensor``'s ``shape``)."""
        flat_layout = _check_layout(flat_layout)
        by_group: Dict[Any, List[str]] = {}
        for k in sorted(params):
            v = params[k]
            if not v.is_floating_point():
                continue
            decay = True if decay_mask is None else bool(
                decay_mask.get(k, True))
            by_group.setdefault((decay, _dtype_name(v.dtype)), []).append(k)
        out = []
        for (decay, dt), keys in sorted(by_group.items()):
            shapes = [tuple(params[k].shape) for k in keys]
            g = {"name": ("decay" if decay else "nodecay") + "|" + dt,
                 "keys": keys, "shapes": shapes,
                 "sizes": [math.prod(sh) for sh in shapes],
                 "dtype": dt, "decay": decay}
            if flat_layout is not None:
                plans = {k: flat_layout.leaf_plan(k, sh)
                         for k, sh in zip(keys, shapes)}
                if keys and all(p is not None for p in plans.values()):
                    g["name"] += "|" + flat_layout.signature
                    g["layout"] = flat_layout
                    g["plans"] = plans
            out.append(g)
        return out

    def _match_flat_groups(self, params, state, decay_mask, flat_layout):
        """Mirror of ``_match_flat_groups``: the groups whose names are the
        state's, under the layout's naming or the row-major one; anything
        else raises, so a state of another wire format never reaches the
        update."""
        candidates = [flat_layout] if flat_layout is not None else []
        candidates.append(None)
        want = set(state["__flat__"])
        tried = []
        for lo in candidates:
            groups = self._flat_groups(params, decay_mask, lo)
            names = {g["name"] for g in groups}
            if names == want:
                return groups
            tried.append(sorted(names))
        raise ValueError(
            f"flat state's groups {sorted(want)} match neither the "
            f"schedule-derived shard-major naming nor the legacy row-major "
            f"naming {tried}: the state was built under a different flat "
            f"layout (mesh/schedule changed?); rebuild it with "
            f"init_flat_state(params, ..., flat_layout=...) for this step's "
            f"schedule")

    def _checked_flat_groups(self, who, params, grads, state, decay_mask,
                             flat_layout):
        """``_match_flat_groups`` for ``who``'s fused update, with its
        refusals: an optimizer-level regularizer instance, a grouped param
        without a gradient."""
        if self._regularizer is not None:
            raise NotImplementedError(
                f"{who}: optimizer-level regularizer instances ride the "
                f"per-param apply; pass weight_decay as a float")
        groups = self._match_flat_groups(params, state, decay_mask,
                                         _check_layout(flat_layout))
        missing = [k for g in groups for k in g["keys"]
                   if grads.get(k) is None]
        if missing:
            raise ValueError(f"{who}: every grouped param needs a gradient "
                             f"(missing: {missing[:3]}...)")
        return groups

    @staticmethod
    def _concat_f32(tensors) -> torch.Tensor:
        return torch.cat([t.float().reshape(-1) for t in tensors])

    @staticmethod
    def _group_flat(g, values, sharded: bool) -> torch.Tensor:
        """The group's fp32 flat buffer of ``values``: this rank's block of
        the shard-major form, or the whole row-major concatenation."""
        lo = g.get("layout")
        if lo is not None:
            if sharded:
                return lo.pack_local(g["plans"], g["keys"], values)
            return lo.pack_group(g["plans"], g["keys"], values)
        if sharded:
            return Adam._concat_f32([values[k].full() for k in g["keys"]])
        return Adam._concat_f32([values[k] for k in g["keys"]])

    @staticmethod
    def _group_leaves(g, flat, params, sharded: bool) -> Dict[str, Any]:
        """The params cut back out of a group's new fp32 master, in their
        dtype: at-rest blocks on a mesh, whole tensors otherwise."""
        from ..parallel.specs import _block_slices

        lo = g.get("layout")
        if lo is not None and sharded:
            blocks = lo.unpack_local(g["plans"], g["keys"], flat, params)
            return {k: params[k].with_local(blocks[k].to(params[k].dtype))
                    for k in g["keys"]}
        if lo is not None:
            leaves = lo.unpack_group(g["plans"], g["keys"], flat)
            return {k: leaves[k].to(params[k].dtype) for k in g["keys"]}
        out, off = {}, 0
        for k, shape, size in zip(g["keys"], g["shapes"], g["sizes"]):
            leaf = flat[off:off + size].reshape(shape).to(params[k].dtype)
            if sharded:
                p = params[k]
                leaf = p.with_local(leaf[_block_slices(p.spec, p.shape,
                                                       p.mesh)].contiguous())
            out[k] = leaf
            off += size
        return out

    def init_flat_state(self, params, decay_mask=None, master_from=None,
                        flat_layout=None):
        """Mirror of ``init_flat_state``: ``{'__flat__': {group: {moment1,
        moment2[, master]}}}``.  ``master_from`` seeds the fp32 masters from
        unrounded values (bf16 params at rest, exact fp32 masters);
        ``flat_layout`` builds the groups in its shard-major format (this
        rank's block of each buffer when the params are ``ShardedTensor``
        blocks)."""
        sharded = _sharded(params.values())
        st = {}
        for g in self._flat_groups(params, decay_mask, flat_layout):
            first = params[g["keys"][0]]
            dev = first.device
            if sharded and "layout" in g:
                n = sum(g["plans"][k].local for k in g["keys"])
            else:
                n = sum(g["sizes"])
            gs = {"moment1": torch.zeros(n, dtype=torch.float32, device=dev),
                  "moment2": torch.zeros(n, dtype=torch.float32, device=dev)}
            if self._multi_precision and g["dtype"] != "float32":
                src = master_from if master_from is not None else params
                gs["master"] = self._group_flat(
                    g, {k: src[k] for k in g["keys"]}, sharded).to(dev)
            st[g["name"]] = gs
        return {"__flat__": st}

    @staticmethod
    def state_is_flat(state) -> bool:
        return isinstance(state, dict) and set(state) == {"__flat__"}

    def _flat_group_update(self, gflat, m1, m2, master, lr, step,
                           decay: bool):
        """Mirror of ``_flat_group_update``: (new_master, new_m1, new_m2)."""
        wd = self._weight_decay if decay else 0.0
        return self._math(gflat, m1, m2, master, lr, step, wd)

    def apply_flat(self, params, grads, state, lr, step: int = 0,
                   decay_mask: Optional[Dict[str, bool]] = None,
                   flat_sharding=None, flat_layout=None):
        """Mirror of ``apply_flat``: one elementwise pass per group over its
        flat fp32 buffers; returns (new_params, new_state) with the new
        params cut back out of the new master, in their dtype.  A group
        without a master (fp32 params) builds it from the params each step.
        ``flat_layout`` selects the groups whose state was built in its
        shard-major format (by their names; a row-major state still
        matches).  With ``ShardedTensor`` params and grads each rank updates
        its block: the grads are reduce-scattered into it over the axes
        they are partial over, and the new params are all-gathered back to
        their at-rest blocks.  ``flat_sharding`` is accepted for the JAX
        signature and unused: placement here is the layout's."""
        if not self.state_is_flat(state):
            raise ValueError("apply_flat needs a state from "
                             "init_flat_state (got per-param state)")
        lr = _pin_lr_f32(lr)
        groups = self._checked_flat_groups("apply_flat", params, grads,
                                           state, decay_mask, flat_layout)
        sharded = _sharded(params.values())
        new_params = dict(params)
        new_flat = {}
        for g in groups:
            gs = state["__flat__"][g["name"]]
            gflat = self._group_flat(g, grads, sharded)
            master = gs.get("master")
            if master is None:
                master = self._group_flat(g, params, sharded)
            new_master, m1, m2 = self._flat_group_update(
                gflat, gs["moment1"], gs["moment2"], master, lr, step,
                g["decay"])
            ngs = {"moment1": m1, "moment2": m2}
            if "master" in gs:
                ngs["master"] = new_master
            new_flat[g["name"]] = ngs
            new_params.update(self._group_leaves(g, new_master, params,
                                                 sharded))
        return new_params, {"__flat__": new_flat}


class AdamW(Adam):
    """Decoupled weight decay (mirror of ``AdamW``; default 0.01).  Eager
    ``step()`` only: ``lr_ratio(param) -> float`` scales each parameter's
    learning rate, and a parameter whose ``name`` fails
    ``apply_decay_param_fun(name)`` gets ``no_weight_decay`` set.  The
    functional paths take a ``decay_mask`` instead."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip,
                         multi_precision=multi_precision, name=name)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio_fn = lr_ratio

    def _param_lr(self, p, lr):
        if self._lr_ratio_fn is None:
            return lr
        return lr * float(self._lr_ratio_fn(p))

    def step(self):
        if self._apply_decay_param_fun is not None:
            for p in self._parameters:
                if not self._apply_decay_param_fun(self.param_name(p)):
                    p.no_weight_decay = True
        super().step()


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def init_param_state(self, value):
        return {"moment": torch.full(value.shape, self._init_acc,
                                     dtype=torch.float32,
                                     device=value.device)}

    def _update(self, value, grad, state, lr, step, wd):
        g = _f32(grad)
        if wd:
            g = g + wd * _f32(value)
        acc = state["moment"] + torch.square(g)
        new_value = _f32(value) - lr * g / (torch.sqrt(acc) + self._eps)
        return new_value.to(value.dtype), {"moment": acc}


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho = rho
        self._eps = epsilon
        self._momentum = momentum
        self._centered = centered

    def init_param_state(self, value):
        st = {"mean_square": _zeros32(value), "momentum": _zeros32(value)}
        if self._centered:
            st["mean_grad"] = _zeros32(value)
        return st

    def _update(self, value, grad, state, lr, step, wd):
        g = _f32(grad)
        if wd:
            g = g + wd * _f32(value)
        ms = self._rho * state["mean_square"] + (1 - self._rho) \
            * torch.square(g)
        st = {"mean_square": ms}
        if self._centered:
            mg = self._rho * state["mean_grad"] + (1 - self._rho) * g
            denom = torch.sqrt(ms - torch.square(mg) + self._eps)
            st["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + self._eps)
        mom = self._momentum * state["momentum"] + lr * g / denom
        st["momentum"] = mom
        return (_f32(value) - mom).to(value.dtype), st


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_param_state(self, value):
        return {"moment": _zeros32(value), "inf_norm": _zeros32(value)}

    def _update(self, value, grad, state, lr, step, wd):
        g = _f32(grad)
        if wd:
            g = g + wd * _f32(value)
        m = self._beta1 * state["moment"] + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * state["inf_norm"], torch.abs(g))
        bc = 1 - self._beta1 ** step
        new_value = _f32(value) - lr / bc * m / (u + self._eps)
        return new_value.to(value.dtype), {"moment": m, "inf_norm": u}


def _norm(x: torch.Tensor) -> torch.Tensor:
    """The 2-norm of x flattened (``jnp.linalg.norm`` with no axis)."""
    return torch.linalg.vector_norm(x)


class Lamb(Optimizer):
    """Layer-wise adaptive moments (mirror of ``Lamb``): the Adam step plus
    decay, scaled per tensor by the trust ratio ||w|| / ||r||.  Eager
    ``step()``: a parameter for which ``exclude_from_weight_decay_fn(p)``
    holds gets ``no_weight_decay`` set."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def step(self):
        if self._exclude_fn is not None:
            for p in self._parameters:
                if self._exclude_fn(p):
                    p.no_weight_decay = True
        super().step()

    def init_param_state(self, value):
        return {"moment1": _zeros32(value), "moment2": _zeros32(value)}

    def _update(self, value, grad, state, lr, step, wd):
        g = _f32(grad)
        vf = _f32(value)
        m1 = self._beta1 * state["moment1"] + (1 - self._beta1) * g
        m2 = self._beta2 * state["moment2"] + (1 - self._beta2) \
            * torch.square(g)
        bc1 = 1 - self._beta1 ** step
        bc2 = 1 - self._beta2 ** step
        r = (m1 / bc1) / (torch.sqrt(m2 / bc2) + self._eps) + wd * vf
        w_norm, r_norm = _norm(vf), _norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        new_value = vf - lr * trust * r
        return new_value.to(value.dtype), {"moment1": m1, "moment2": m2}


class LarsMomentum(Optimizer):
    """LARS momentum (mirror of ``LarsMomentum``): per-tensor trust ratio
    ``local_lr = lr * coeff * ||w|| / (||g|| + wd * ||w|| + eps)``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 epsilon=1e-8, exclude_from_weight_decay=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._momentum = momentum
        self._coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._eps = epsilon
        self._exclude = exclude_from_weight_decay or []

    def init_param_state(self, value):
        return {"velocity": _zeros32(value)}

    def _update(self, value, grad, state, lr, step, wd):
        g = _f32(grad)
        w = _f32(value)
        w_norm, g_norm = _norm(w), _norm(g)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            lr * self._coeff * w_norm
            / (g_norm + self._lars_wd * w_norm + self._eps),
            _scalar32(lr, w))
        v = self._momentum * state["velocity"] \
            + local_lr * (g + self._lars_wd * w)
        return (w - v).to(value.dtype), {"velocity": v}


class Adadelta(Optimizer):
    """Mirror of ``Adadelta`` (Zeiler 2012): running means of the squared
    gradients and of the squared updates."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._rho = rho

    def init_param_state(self, value):
        return {"avg_squared_grad": torch.zeros_like(value),
                "avg_squared_update": torch.zeros_like(value)}

    def _update(self, value, grad, state, lr, step, wd):
        if wd:
            grad = grad + wd * value
        g2 = self._rho * state["avg_squared_grad"] \
            + (1 - self._rho) * grad * grad
        upd = grad * torch.sqrt(state["avg_squared_update"] + self._epsilon) \
            / torch.sqrt(g2 + self._epsilon)
        u2 = self._rho * state["avg_squared_update"] \
            + (1 - self._rho) * upd * upd
        return value - lr * upd, {"avg_squared_grad": g2,
                                  "avg_squared_update": u2}


class ASGD(Optimizer):
    """Averaged SGD (mirror of ``ASGD``): ``d`` is the running sum of the
    last ``batch_num`` gradients, kept in a circular buffer; the step is
    ``param -= (lr / n) * d`` with n = min(seen, batch_num)."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._batch_num = max(int(batch_num), 1)

    def init_param_state(self, value):
        n = value.numel()
        dev = value.device
        return {"d": torch.zeros(n, dtype=torch.float32, device=dev),
                "hist": torch.zeros((self._batch_num, n),
                                    dtype=torch.float32, device=dev),
                "seen": torch.zeros((), dtype=torch.int32, device=dev)}

    def _update(self, value, grad, state, lr, step, wd):
        if wd:
            grad = grad + wd * value
        g = _f32(grad).reshape(-1)
        slot = (state["seen"] % self._batch_num).long().reshape(1)
        y = state["hist"].index_select(0, slot)[0]   # evicted this turn
        d = state["d"] - y + g
        hist = state["hist"].index_copy(0, slot, g[None])
        n = torch.clamp(state["seen"] + 1, max=self._batch_num).float()
        new_value = value - ((lr / n) * d).reshape(value.shape).to(
            value.dtype)
        return new_value, {"d": d, "hist": hist, "seen": state["seen"] + 1}


class Rprop(Optimizer):
    """Resilient backprop (mirror of ``Rprop``): per-weight step sizes
    grown or shrunk by the sign agreement of successive gradients; a sign
    flip zeroes that step's gradient."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas

    def init_param_state(self, value):
        return {"prev_grad": torch.zeros_like(value),
                "step_size": torch.full(value.shape, float(self.get_lr()),
                                        dtype=torch.float32,
                                        device=value.device)}

    def _update(self, value, grad, state, lr, step, wd):
        sign = torch.sign(grad * state["prev_grad"])
        one = torch.ones_like(sign)
        factor = torch.where(sign > 0, self._eta_pos * one,
                             torch.where(sign < 0, self._eta_neg * one, one))
        step_size = torch.clamp(state["step_size"] * factor, self._lr_min,
                                self._lr_max)
        eff_grad = torch.where(sign < 0, torch.zeros_like(grad), grad)
        new_value = value - torch.sign(eff_grad) * step_size
        return new_value, {"prev_grad": eff_grad, "step_size": step_size}


class NAdam(Optimizer):
    """Mirror of ``NAdam`` (Dozat 2016): Adam with Nesterov momentum by the
    mu-product schedule, the schedule in fp32 as the JAX package has it."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2 = beta1, beta2
        self._epsilon = epsilon
        self._psi = momentum_decay

    def init_param_state(self, value):
        return {"m": _zeros32(value), "v": _zeros32(value),
                "mu_product": torch.ones((), dtype=torch.float32,
                                         device=value.device)}

    def _update(self, value, grad, state, lr, step, wd):
        if wd:
            grad = grad + wd * value
        t = _scalar32(step, value)
        gf = _f32(grad)
        mu_t = self._beta1 * (1.0 - 0.5 * 0.96 ** (t * self._psi))
        mu_t1 = self._beta1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * self._psi))
        mu_prod = state["mu_product"] * mu_t
        m = self._beta1 * state["m"] + (1 - self._beta1) * gf
        v = self._beta2 * state["v"] + (1 - self._beta2) * gf * gf
        m_hat = mu_t1 * m / (1 - mu_prod * mu_t1) \
            + (1 - mu_t) * gf / (1 - mu_prod)
        v_hat = v / (1 - self._beta2 ** t)
        upd = lr * m_hat / (torch.sqrt(v_hat) + self._epsilon)
        return (value - upd.to(value.dtype),
                {"m": m, "v": v, "mu_product": mu_prod})


class RAdam(Optimizer):
    """Rectified Adam (mirror of ``RAdam``, Liu et al. 2020): the variance
    rectification switches from SGD with momentum to Adam once rho_t > 5;
    1 - beta2^t by expm1 in fp32, as the JAX package computes it."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2 = beta1, beta2
        self._epsilon = epsilon

    def init_param_state(self, value):
        return {"m": _zeros32(value), "v": _zeros32(value)}

    def _update(self, value, grad, state, lr, step, wd):
        if wd:
            grad = grad + wd * value
        t = _scalar32(step, value)
        gf = _f32(grad)
        m = self._beta1 * state["m"] + (1 - self._beta1) * gf
        v = self._beta2 * state["v"] + (1 - self._beta2) * gf * gf
        rho_inf = 2.0 / (1 - self._beta2) - 1.0
        one_minus_beta2_t = -torch.expm1(
            t * torch.log(_scalar32(self._beta2, value)))
        beta2_t = 1.0 - one_minus_beta2_t
        rho_t = rho_inf - 2.0 * t * beta2_t / one_minus_beta2_t
        m_hat = m / (1 - self._beta1 ** t)
        rect = torch.sqrt(((rho_t - 4) * (rho_t - 2) * rho_inf)
                          / torch.clamp((rho_inf - 4) * (rho_inf - 2)
                                        * rho_t, min=1e-12))
        v_hat = torch.sqrt(v / one_minus_beta2_t)
        adam_step = rect * m_hat / (v_hat + self._epsilon)
        upd = lr * torch.where(rho_t > 5.0, adam_step, m_hat)
        return value - upd.to(value.dtype), {"m": m, "v": v}


class LBFGS(Optimizer):
    """Limited-memory BFGS (mirror of ``LBFGS``): the two-loop recursion
    over the last ``history_size`` (s, y) pairs, a fixed learning rate in
    place of a line search.  ``step(closure)`` runs up to ``max_iter``
    iterations, each re-evaluating the loss with ``closure()`` (which calls
    ``backward``), stopping on the gradient or parameter-change tolerance,
    and returns the last loss; ``step()`` is one direction step over the
    ``.grad`` already there."""

    def __init__(self, learning_rate=1.0, max_iter=20, tolerance_grad=1e-7,
                 tolerance_change=1e-9, history_size=10,
                 line_search_fn=None, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._hist = int(history_size)
        self._max_iter = int(max_iter)
        self._tol_grad = float(tolerance_grad)
        self._tol_change = float(tolerance_change)

    def init_param_state(self, value):
        h, n, dev = self._hist, value.numel(), value.device
        return {"s": torch.zeros((h, n), dtype=torch.float32, device=dev),
                "y": torch.zeros((h, n), dtype=torch.float32, device=dev),
                "rho": torch.zeros(h, dtype=torch.float32, device=dev),
                "prev_x": torch.zeros(n, dtype=torch.float32, device=dev),
                "prev_g": torch.zeros(n, dtype=torch.float32, device=dev),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    @staticmethod
    def _push(buf, new, valid):
        rolled = torch.roll(buf, -1, 0)
        rolled[-1] = new
        return torch.where(valid, rolled, buf)

    def _update(self, value, grad, state, lr, step, wd):
        if wd:
            grad = grad + wd * value
        x = _f32(value).reshape(-1)
        g = _f32(grad).reshape(-1)
        h, cnt = self._hist, state["count"]
        # push the newest (s, y) pair once there is a previous point
        s_new, y_new = x - state["prev_x"], g - state["prev_g"]
        sy = torch.dot(s_new, y_new)
        valid = (cnt > 0) & (sy > 1e-10)
        s_buf = self._push(state["s"], s_new, valid)
        y_buf = self._push(state["y"], y_new, valid)
        rho_buf = self._push(state["rho"], 1.0 / torch.clamp(sy, min=1e-10),
                             valid)
        # two-loop recursion (zero rho entries are inert)
        q, alphas = g, [None] * h
        for j in range(h - 1, -1, -1):
            alphas[j] = rho_buf[j] * torch.dot(s_buf[j], q)
            q = q - alphas[j] * y_buf[j]
        ys = torch.dot(y_buf[-1], y_buf[-1])
        gamma = torch.where(ys > 0, torch.dot(s_buf[-1], y_buf[-1])
                            / torch.clamp(ys, min=1e-10),
                            torch.ones_like(ys))
        r = q * torch.where(valid | (cnt > 1), gamma, torch.ones_like(gamma))
        for j in range(h):
            b = rho_buf[j] * torch.dot(y_buf[j], r)
            r = r + s_buf[j] * (alphas[j] - b)
        new_x = x - lr * r
        # copies: x and g may alias the parameter (updated in place by the
        # eager step) and its .grad
        new_state = {"s": s_buf, "y": y_buf, "rho": rho_buf,
                     "prev_x": x.clone(), "prev_g": g.clone(),
                     "count": cnt + 1}
        return new_x.reshape(value.shape).to(value.dtype), new_state

    def step(self, closure=None):
        if closure is None:
            return super().step()
        loss = None
        for _ in range(self._max_iter):
            for p in self._parameters:
                p.grad = None
            with torch.enable_grad():
                loss = closure()
            before = [p.detach().clone() for p in self._parameters]
            gmax = max((float(p.grad.abs().max()) for p in self._parameters
                        if p.grad is not None), default=0.0)
            if gmax <= self._tol_grad:
                break
            super().step()
            change = max(float((p.detach() - b).abs().max())
                         for p, b in zip(self._parameters, before))
            if change <= self._tol_change:
                break
        return loss
