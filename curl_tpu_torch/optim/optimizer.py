"""Optimizer base for encrypted parameters (counterpart of
``curl_tpu/optim/optimizer.py``; the reference's curl/optim/optimizer.py:
28-95): parameter groups, each with the defaults filled in."""

from __future__ import annotations


class Optimizer:
    def __init__(self, params, defaults):
        self.defaults = defaults
        self.param_groups = []
        params = list(params)
        if len(params) == 0:
            raise ValueError("optimizer got an empty parameter list")
        if not isinstance(params[0], dict):
            params = [{"params": params}]
        for group in params:
            self.add_param_group(group)

    def add_param_group(self, group):
        if not isinstance(group, dict):
            group = {"params": group}
        if not isinstance(group["params"], list):
            group["params"] = [group["params"]]
        for name, default in self.defaults.items():
            group.setdefault(name, default)
        self.param_groups.append(group)

    def zero_grad(self):
        """Clear the gradient of every parameter of every group."""
        for group in self.param_groups:
            for p in group["params"]:
                p.grad = None

    def step(self, closure=None):
        raise NotImplementedError
