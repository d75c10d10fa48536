"""Differentially private split-model training, label DP (counterpart of
``curl_tpu/nn/privacy.py``; the reference's curl/nn/privacy/dp_split.py:
62-549).

The feature party runs a plain torch model (on the card, or wherever its
parameters lie) and encrypts its logits; the label party encrypts its
labels. The loss's gradient with respect to the logits, sigmoid(z) - y over
the element count, is computed privately; DP noise is added to the
parameter gradients before they are decrypted, and torch's own backward
resumes from there. Two gradient protocols (``cfg.nn.dpsmpc.protocol``):

  "layer_estimation"  (the default) dL/dW of the last Linear layer
                      privately, revealed with noise; dL/dZ solved from it
                      by the pseudo-inverse of that layer's input, in
                      float64 on the input's device, and torch's backward
                      run from the logits;
  "full_jacobian"     every parameter's Jacobian of the logits, one (Z, P)
                      matrix, encrypted by the feature party; dL/dZ times it
                      privately (one product), revealed with noise into
                      each parameter's ``grad``.

Labels may be flipped by randomized response, private Bernoulli draws, and
the loss may be RAPPOR's. Every draw is the session's (``ct.randn``,
``ct.bernoulli``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import cfg
from ..mpc.mpc import MPCTensor
from .loss import BCELoss, RAPPORLoss
from .module import Module


class DPSplitModel(Module):
    def __init__(self, pytorch_model, feature_src=0, label_src=1, noise_magnitude=None,
                 noise_src=None, randomized_response_prob=None, rappor_prob=None):
        super().__init__()
        self.noise_magnitude = noise_magnitude
        self.feature_src = feature_src
        self.label_src = label_src
        self.noise_src = noise_src
        self.model = pytorch_model
        if randomized_response_prob is not None:
            assert 0 < randomized_response_prob < 0.5
        self.rr_prob = randomized_response_prob
        if rappor_prob is not None:
            assert 0 <= rappor_prob <= 1
        self.alpha = rappor_prob
        self.preds = None
        self.logits = None

    @property
    def skip_loss_forward(self):
        return cfg.nn.dpsmpc.skip_loss_forward

    @property
    def protocol(self):
        return cfg.nn.dpsmpc.protocol

    def zero_grad(self, set_to_none: bool = True):
        self.model.zero_grad()

    def _model_device(self):
        p = next(self.model.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    def forward(self, input):
        """The feature party's plaintext forward; its logits encrypted for
        the loss (dp_split.py:182)."""
        if not torch.is_tensor(input):
            input = torch.from_numpy(np.asarray(input))
        self.logits_torch = self.model(input.to(self._model_device()).float())
        self.logits = MPCTensor.encrypt(self.logits_torch.detach().to(torch.float64),
                                     src=self.feature_src)
        self.preds = self.logits.sigmoid()
        return self.logits

    def _process_targets(self, targets):
        """The label party's encrypted targets, flipped by randomized
        response where configured (dp_split.py:260)."""
        import curl_tpu_torch

        if isinstance(targets, MPCTensor):
            targets_enc = targets
        else:
            if torch.is_tensor(targets):
                targets = targets.detach().to(torch.float64)
            else:
                targets = np.asarray(targets, dtype=np.float64)
            targets_enc = MPCTensor.encrypt(targets, src=self.label_src)
        if self.rr_prob is not None:
            flip = curl_tpu_torch.bernoulli(np.full(tuple(targets_enc.shape), self.rr_prob))
            targets_enc = targets_enc.add(flip).sub(targets_enc.mul(flip).mul(2))
        return targets_enc

    def compute_loss(self, targets):
        """The encrypted BCE loss (RAPPOR's where configured) and dL/dZ =
        (preds - targets) / n (dp_split.py:285)."""
        self.targets = self._process_targets(targets)
        if self.skip_loss_forward:
            self.loss = _SkippedLoss("loss forward skipped (see config)")
        elif self.alpha is not None:
            self.loss = RAPPORLoss(self.alpha)(self.preds, self.targets)
        else:
            self.loss = BCELoss()(self.preds, self.targets)
        self.dLdZ = self.preds.sub(self.targets).div(self.preds.nelement())
        return self.loss

    def _add_dp_if_necessary(self, grad):
        if self.noise_magnitude is None or self.noise_magnitude == 0.0:
            return grad
        import curl_tpu_torch

        return grad.add(curl_tpu_torch.randn(*tuple(grad.shape)).mul(self.noise_magnitude))

    def _get_last_linear_layer(self):
        return [m for m in self.model.modules() if isinstance(m, torch.nn.Linear)][-1]

    def _backward_layer_estimation(self):
        """dL/dW of the last Linear layer privately, noise, decrypt, dL/dZ
        solved from it, torch's backward (dp_split.py:476-533)."""
        x_in = self._last_input.detach()
        # dL/dW = dL/dZ^T @ X, X encrypted by the feature party
        dLdW = self.dLdZ.transpose(0, 1).matmul(
            MPCTensor.encrypt(x_in.to(torch.float64), src=self.feature_src))
        dLdW = self._add_dp_if_necessary(dLdW)
        dLdW_plain = torch.from_numpy(np.asarray(dLdW.get_plain_text(), dtype=np.float64))
        # dL/dW = dL/dZ^T X  =>  dL/dZ = (dL/dW pinv(X))^T  (dp_split.py:476)
        x64 = x_in.to(torch.float64)
        dLdZ_est = (dLdW_plain.to(x64.device) @ torch.linalg.pinv(x64)).T
        self.logits_torch.backward(
            dLdZ_est.reshape(self.logits_torch.shape).to(self.logits_torch.dtype))

    def _jacobian(self):
        """The logits' Jacobian in every parameter: (the (Z, P) matrix, the
        parameters), P the parameters' sizes in order (dp_split.py:369-420).
        One backward a logit, each in all the parameters."""
        params = list(self.model.parameters())
        flat = self.logits_torch.flatten()
        rows = []
        for i in range(flat.numel()):
            grads = torch.autograd.grad(flat[i], params, retain_graph=True, allow_unused=True)
            rows.append(torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                                   for p, g in zip(params, grads)]))
        return torch.stack(rows), params

    def _backward_full_jacobian(self):
        """dL/dW = dL/dZ J with the Jacobian encrypted by the feature party,
        one private product, noise, decrypted into each parameter's grad
        (dp_split.py:369-474)."""
        jac, params = self._jacobian()
        jac_enc = MPCTensor.encrypt(jac.detach().to(torch.float64), src=self.feature_src)
        del jac
        grad = self._add_dp_if_necessary(self.dLdZ.flatten().matmul(jac_enc))
        flat = torch.from_numpy(np.asarray(grad.get_plain_text(), dtype=np.float64))
        start = 0
        for p in params:
            n = p.numel()
            p.grad = flat[start:start + n].reshape(p.shape).to(device=p.device, dtype=p.dtype)
            start += n

    def backward(self, grad_output=None):
        if self.protocol == "full_jacobian":
            self._backward_full_jacobian()
        else:
            if not hasattr(self, "_last_input"):
                raise RuntimeError(
                    "attach_hooks() must be called before forward for layer_estimation protocol")
            self._backward_layer_estimation()

    def attach_hooks(self):
        """A forward hook that keeps the last Linear layer's input."""

        def hook(mod, inp, out):
            self._last_input = inp[0]

        self._get_last_linear_layer().register_forward_hook(hook)
        return self


class _SkippedLoss:
    """What the loss is when skip_loss_forward is set (dp_split.py:20)."""

    def __init__(self, msg=""):
        self.msg = msg

    def __repr__(self):
        return f"SkippedLoss({self.msg})"
