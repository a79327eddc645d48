"""paddle.regularizer — L1Decay / L2Decay (port of paddle_tpu's
`regularizer.py`).

The optimizer folds the decay into the gradient at update time: L2Decay
as coeff * param and L1Decay as coeff * sign(param), both added to the
gradient (grad-side, so the decay also reaches AdamW, whose own
weight_decay is decoupled). A `ParamAttr(regularizer=...)` on a parameter
overrides the optimizer-wide `weight_decay` regularizer, as in the
reference (fluid/regularizer.py append_regularization_ops).
"""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    _l1 = False

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L1Decay(WeightDecayRegularizer):
    """loss += coeff * sum(|param|)  ->  grad += coeff * sign(param)."""

    _l1 = True


class L2Decay(WeightDecayRegularizer):
    """loss += 0.5 * coeff * sum(param^2)  ->  grad += coeff * param."""

    _l1 = False
