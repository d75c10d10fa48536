"""Loss modules over encrypted tensors (counterpart of
``curl_tpu/nn/loss.py``; the reference's curl/nn/loss.py:14-198).

Each computes what the JAX package's computes, op for op, so its rounds and
bytes are curl_tpu's. A target is an encrypted tensor or a public array
(numpy or torch); ``CrossEntropyLoss`` takes one-hot targets.
"""

from __future__ import annotations

import numpy as np

from .module import Module


def _is_enc(y):
    return hasattr(type(y), "share")


def _public(y):
    """A public target as a float64 numpy array (a torch tensor as it is)."""
    return y if hasattr(y, "detach") else np.asarray(y, dtype=np.float64)


class _Loss(Module):
    def __init__(self, reduction="mean", skip_forward=False):
        super().__init__()
        if reduction != "mean":
            raise NotImplementedError("only mean reduction is supported")
        self.reduction = reduction
        self.skip_forward = skip_forward


class MSELoss(_Loss):
    """mean (x - y)^2 (loss.py:42)."""

    def forward(self, x, y):
        return (x - y).square().mean()


class L1Loss(_Loss):
    """mean |x - y| (loss.py:14)."""

    def forward(self, x, y):
        return (x - y).abs().mean()


class BCELoss(_Loss):
    """-mean [y log x + (1 - y) log(1 - x)] (loss.py:69).

    The probabilities are shifted by x32 into the accurate interior of the
    log LUT's domain [0, 64] before the lookup (log x = log 32x - log 32),
    as the JAX package does; the reference reads the raw LUT's coarse first
    cell here."""

    _LN32 = 3.4657359027997265

    def forward(self, x, y):
        log_pos = x.mul(32).log() - self._LN32
        log_neg = (x.neg() + 1).mul(32).log() - self._LN32
        if _is_enc(y):
            ce = y.mul(log_pos) + (y.neg() + 1).mul(log_neg)
        else:
            y = _public(y)
            ce = log_pos.mul(y) + log_neg.mul(1 - y)
        return ce.mean().neg()


class BCEWithLogitsLoss(_Loss):
    """BCE on sigmoid(x) (loss.py:155)."""

    def forward(self, x, y):
        return BCELoss().forward(x.sigmoid(), y)


class CrossEntropyLoss(_Loss):
    """Softmax cross-entropy over the last axis; ``y`` one-hot (loss.py:105):
    -sum(y * log_softmax(x)) / batch."""

    def forward(self, x, y):
        x = x.log_softmax(-1)
        prod = y.mul(x) if _is_enc(y) else x.mul(_public(y))
        n = x.shape[0] if x.shape else 1
        return prod.sum().div(n).neg()


class RAPPORLoss(_Loss):
    """Randomized-response BCE (loss.py:166): p' = alpha p + (1 - alpha)(1 - p)."""

    def __init__(self, alpha, reduction="mean", skip_forward=False):
        super().__init__(reduction=reduction, skip_forward=skip_forward)
        self.alpha = alpha

    def forward(self, x, y):
        pred = x.mul(self.alpha) + x.neg().add(1).mul(1 - self.alpha)
        return BCELoss().forward(pred, y)
