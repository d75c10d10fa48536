"""Distance modules (counterpart of ``curl_tpu/nn/distances.py``)."""

from __future__ import annotations

from .module import Module


class CosineSimilarity(Module):
    """cos(x1, x2) along ``dim`` (distances.py:8-23): the dot product times
    one private inv_sqrt of the product of the squared norms plus eps."""

    def __init__(self, dim=1, eps=1e-6):
        super().__init__()
        self.dim = dim
        self.eps = eps

    def forward(self, x1, x2=None):
        if x2 is None:
            x1, x2 = x1
        dot = x1.mul(x2).sum(axis=self.dim, keepdim=True)
        n1 = x1.square().sum(axis=self.dim, keepdim=True)
        n2 = x2.square().sum(axis=self.dim, keepdim=True)
        inv_norm = (n1.mul(n2) + self.eps).inv_sqrt()
        return dot.mul(inv_norm).squeeze(self.dim)
