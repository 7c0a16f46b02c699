"""Weight-decay regularizers (mirror of ``paddle_tpu/regularizer.py``).

``L1Decay`` and ``L2Decay`` add a decay term to each parameter's gradient
before the optimizer update: globally through
``Optimizer(weight_decay=L2Decay(...))``, or per parameter through a
``regularizer`` attribute set on the ``torch.nn.Parameter`` (eager
``step()``) or the ``regularizers=`` dict of ``Optimizer.apply``.  A
per-parameter regularizer overrides the optimizer-level one and its float
``weight_decay``, the reference's precedence rule.
"""

from __future__ import annotations

import torch

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self) -> float:
        return self._coeff

    def _apply(self, value: torch.Tensor) -> torch.Tensor:
        """The gradient contribution d(penalty)/d(value)."""
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L1Decay(WeightDecayRegularizer):
    """Lasso: penalty coeff * sum|w|, gradient term coeff * sign(w)."""

    def _apply(self, value):
        return (self._coeff * torch.sign(value)).to(value.dtype)


class L2Decay(WeightDecayRegularizer):
    """Ridge: penalty 0.5 * coeff * sum w^2, gradient term coeff * w."""

    def _apply(self, value):
        return (self._coeff * value).to(value.dtype)
