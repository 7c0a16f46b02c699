"""Adam and AdamW with fp32 masters: per-tensor and fused flat updates.

Port of the functional core of ``paddle_tpu/optimizer/optimizer.py``
(``Optimizer``, ``Adam``, ``AdamW``) that the compiled train step uses:

- ``apply(params, grads, state, lr, step, decay_mask)``: per-tensor update
  over a ``{name: {moment1, moment2[, master]}}`` state (``init_state``);
- ``apply_flat``: the fused multi-tensor update over flat fp32 buffers, one
  per (decay?, dtype) group (``init_flat_state``; the state is
  ``{"__flat__": {group: {moment1, moment2[, master]}}}`` with the JAX
  package's group names, e.g. ``decay|bfloat16``).

The update is plain elementwise PyTorch, as the JAX package left it to XLA.
Both paths are functional: they return new params and a new state and leave
their inputs untouched.  Where JAX donates the old buffers, the caller here
drops its references and PyTorch's caching allocator reuses the memory.
Only the row-major flat layout is ported; the shard-major ``flat_layout``
of multi-GPU training raises.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch


def _pin_lr_f32(lr):
    """Mirror of ``_pin_lr_f32``: a float64 tensor lr becomes float32 so it
    cannot promote the update chain; Python floats pass unchanged."""
    if isinstance(lr, torch.Tensor) and lr.dtype == torch.float64:
        return lr.to(torch.float32)
    return lr


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]           # torch.bfloat16 -> bfloat16


def _flat_layout_unported():
    return NotImplementedError(
        "the shard-major flat_layout belongs to multi-GPU training "
        "(ROADMAP queue A5), not ported yet")


class Optimizer:
    """Functional optimizer base (mirror of ``Optimizer``'s functional core):
    ``learning_rate`` and a float ``weight_decay``."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported yet")
        if weight_decay is not None and not isinstance(weight_decay,
                                                       (int, float)):
            raise NotImplementedError(
                "regularizer instances are not ported; pass weight_decay as "
                "a float")
        # ``parameters`` is accepted for the JAX signature; the functional
        # update takes its tensors as arguments
        self._lr = learning_rate
        self._weight_decay = 0.0 if weight_decay is None \
            else float(weight_decay)

    def get_lr(self) -> float:
        return float(self._lr)

    def init_param_state(self, value) -> Dict[str, Any]:
        return {}

    def update(self, value, grad, state, lr, step: int):
        """Pure single-tensor update: returns (new_value, new_state)."""
        return self._update(value, grad, state, lr, step, self._weight_decay)

    def _update(self, value, grad, state, lr, step, weight_decay):
        raise NotImplementedError

    def init_state(self, params: Dict[str, torch.Tensor]):
        return {k: self.init_param_state(v) for k, v in params.items()}

    def apply(self, params, grads, state, lr, step: int = 0,
              decay_mask: Optional[Dict[str, bool]] = None):
        """Per-tensor update; returns (new_params, new_state).  A parameter
        masked out of ``decay_mask`` updates with weight decay 0; one
        without a gradient passes through."""
        lr = _pin_lr_f32(lr)
        new_params, new_state = {}, {}
        for k, v in params.items():
            g = grads.get(k)
            if g is None:
                new_params[k] = v
                new_state[k] = state.get(k, {})
                continue
            st = state.get(k) or self.init_param_state(v)
            masked = decay_mask is not None and not decay_mask.get(k, True)
            wd = 0.0 if masked else self._weight_decay
            nv, ns = self._update(v, g, st, lr, step, wd)
            new_params[k] = nv.to(v.dtype)
            new_state[k] = ns
        return new_params, new_state


class Adam(Optimizer):
    """Mirror of ``Adam``: L2 weight decay coupled into the gradient, fp32
    moments, and with ``multi_precision`` an fp32 master for every non-fp32
    parameter."""

    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        if lazy_mode:
            raise NotImplementedError("lazy_mode is not ported")
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon
        self._multi_precision = multi_precision

    def init_param_state(self, value):
        st = {"moment1": torch.zeros(value.shape, dtype=torch.float32,
                                     device=value.device),
              "moment2": torch.zeros(value.shape, dtype=torch.float32,
                                     device=value.device)}
        if self._multi_precision and value.dtype != torch.float32:
            st["master"] = value.float()
        return st

    def _math(self, g, m1, m2, master, lr, step, wd):
        """The elementwise Adam/AdamW step shared by ``update`` and the flat
        groups (``_flat_group_update``): returns (master, m1, m2)."""
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

    def _update(self, value, grad, state, lr, step, weight_decay):
        master = state.get("master", value.float())
        new_master, m1, m2 = self._math(grad.float(), state["moment1"],
                                        state["moment2"], master, lr, step,
                                        weight_decay)
        new_state = {"moment1": m1, "moment2": m2}
        if "master" in state or (self._multi_precision
                                 and value.dtype != torch.float32):
            new_state["master"] = new_master
        return new_master.to(value.dtype), new_state

    # ---- fused multi-tensor (flat) path

    def _flat_groups(self, params, decay_mask=None, flat_layout=None
                     ) -> List[Dict[str, Any]]:
        """Mirror of ``_flat_groups`` (row-major only): float params grouped
        by (decay?, dtype), keys sorted, so init and every apply agree."""
        if flat_layout is not None:
            raise _flat_layout_unported()
        by_group: Dict[Any, List[str]] = {}
        for k in sorted(params):
            v = params[k]
            if not torch.is_floating_point(v):
                continue
            decay = True if decay_mask is None else bool(
                decay_mask.get(k, True))
            by_group.setdefault((decay, _dtype_name(v.dtype)), []).append(k)
        out = []
        for (decay, dt), keys in sorted(by_group.items()):
            shapes = [tuple(params[k].shape) for k in keys]
            out.append({"name": ("decay" if decay else "nodecay") + "|" + dt,
                        "keys": keys, "shapes": shapes,
                        "sizes": [params[k].numel() for k in keys],
                        "dtype": dt, "decay": decay})
        return out

    @staticmethod
    def _concat_f32(tensors) -> torch.Tensor:
        return torch.cat([t.float().reshape(-1) for t in tensors])

    def init_flat_state(self, params, decay_mask=None, master_from=None,
                        flat_layout=None):
        """Mirror of ``init_flat_state``: ``{'__flat__': {group: {moment1,
        moment2[, master]}}}``.  ``master_from`` seeds the fp32 masters from
        unrounded values (bf16 params at rest, exact fp32 masters)."""
        st = {}
        for g in self._flat_groups(params, decay_mask, flat_layout):
            dev = params[g["keys"][0]].device
            n = sum(g["sizes"])
            gs = {"moment1": torch.zeros(n, dtype=torch.float32, device=dev),
                  "moment2": torch.zeros(n, dtype=torch.float32, device=dev)}
            if self._multi_precision and g["dtype"] != "float32":
                src = master_from if master_from is not None else params
                gs["master"] = self._concat_f32(
                    [src[k].to(dev) for k in g["keys"]])
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
        """Mirror of ``apply_flat`` (row-major): one elementwise pass per
        group over its flat fp32 buffers; returns (new_params, new_state)
        with the new params cut back out of the new master, in their
        dtype.  A group without a master (fp32 params) builds it from the
        params each step."""
        if not self.state_is_flat(state):
            raise ValueError("apply_flat needs a state from "
                             "init_flat_state (got per-param state)")
        if flat_sharding is not None or flat_layout is not None:
            raise _flat_layout_unported()
        lr = _pin_lr_f32(lr)
        groups = self._flat_groups(params, decay_mask)
        names = {g["name"] for g in groups}
        if names != set(state["__flat__"]):
            raise ValueError(f"flat state's groups {sorted(state['__flat__'])}"
                             f" do not match the params' {sorted(names)}")
        missing = [k for g in groups for k in g["keys"]
                   if grads.get(k) is None]
        if missing:
            raise ValueError(f"apply_flat: every grouped param needs a "
                             f"gradient (missing: {missing[:3]}...)")
        new_params = dict(params)
        new_flat = {}
        for g in groups:
            gs = state["__flat__"][g["name"]]
            gflat = self._concat_f32([grads[k] for k in g["keys"]])
            master = gs.get("master")
            if master is None:
                master = self._concat_f32([params[k] for k in g["keys"]])
            new_master, m1, m2 = self._flat_group_update(
                gflat, gs["moment1"], gs["moment2"], master, lr, step,
                g["decay"])
            ngs = {"moment1": m1, "moment2": m2}
            if "master" in gs:
                ngs["master"] = new_master
            new_flat[g["name"]] = ngs
            dtype = params[g["keys"][0]].dtype
            off = 0
            for k, shape, size in zip(g["keys"], g["shapes"], g["sizes"]):
                new_params[k] = new_master[off:off + size].reshape(
                    shape).to(dtype)
                off += size
        return new_params, {"__flat__": new_flat}


class AdamW(Adam):
    """Decoupled weight decay (mirror of ``AdamW``; default 0.01)."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=True, name=None):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError(
                "lr_ratio / apply_decay_param_fun ride the eager step, not "
                "ported; pass a decay_mask to apply/apply_flat")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip,
                         multi_precision=multi_precision, name=name)
