"""Weight-decay regularizers (a copy of the reference package's
``regularizer.py``): the optimizer folds ``coeff * param`` (L2) or
``coeff * sign(param)`` (L1) into the gradient.
"""

__all__ = ["L1Decay", "L2Decay"]


class L1Decay:
    _l1 = True

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"L1Decay(coeff={self.coeff})"


class L2Decay:
    _l1 = False

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"L2Decay(coeff={self.coeff})"
