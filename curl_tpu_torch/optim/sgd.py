"""SGD over encrypted parameters (counterpart of ``curl_tpu/optim/sgd.py``;
the reference's curl/optim/sgd.py:13-150).

Momentum, dampening, weight decay and Nesterov, and the reference's
square-threshold guard (``grad_threshold``: a gradient whose square
exceeds grad_threshold^2 is zeroed, at the cost of one comparison). A step
runs outside the tape and swaps each parameter's shares in place, so the
tensors a model and its optimizer hold stay the same objects.
"""

from __future__ import annotations

from .optimizer import Optimizer


class SGD(Optimizer):
    def __init__(self, params, lr, momentum=0, dampening=0, weight_decay=0,
                 nesterov=False, grad_threshold=None):
        if not isinstance(lr, (int, float)) or lr < 0.0:
            raise ValueError(f"Invalid learning rate: {lr}")
        if momentum < 0.0:
            raise ValueError(f"Invalid momentum value: {momentum}")
        if weight_decay < 0.0:
            raise ValueError(f"Invalid weight_decay value: {weight_decay}")
        defaults = {
            "lr": lr,
            "momentum": momentum,
            "dampening": dampening,
            "weight_decay": weight_decay,
            "nesterov": nesterov,
        }
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires a momentum and zero dampening")
        super().__init__(params, defaults)
        self.grad_threshold = grad_threshold
        if grad_threshold is not None:
            self.square_threshold = grad_threshold * grad_threshold
        self._momentum_buffers = {}

    def step(self, closure=None):
        from ..autograd import no_grad

        loss = None
        if closure is not None:
            loss = closure()
        with no_grad():
            self._step_inner()
        return loss

    def _step_inner(self):
        for group in self.param_groups:
            weight_decay = group["weight_decay"]
            momentum = group["momentum"]
            dampening = group["dampening"]
            nesterov = group["nesterov"]
            lr = group["lr"]

            for i, p in enumerate(group["params"]):
                if getattr(p, "grad", None) is None:
                    continue
                d_p = p.grad
                if self.grad_threshold is not None:
                    d_p = d_p.mul(d_p.square().lt(self.square_threshold))
                if weight_decay != 0:
                    d_p = d_p.add(p.mul(weight_decay))
                if momentum != 0:
                    key = (id(group), i)
                    buf = self._momentum_buffers.get(key)
                    if buf is None:
                        buf = d_p
                    else:
                        buf = buf.mul(momentum).add(d_p.mul(1 - dampening))
                    self._momentum_buffers[key] = buf
                    if nesterov:
                        d_p = d_p.add(buf.mul(momentum))
                    else:
                        d_p = buf

                # the parameter's shares swapped in place (sgd.py:74-82); in a
                # lazy scope the parameter becomes the pending update
                p._assign(p.sub(d_p.mul(lr)))
