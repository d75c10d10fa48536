"""The port's ResNet modules against curl_tpu and float64.

* ``BasicBlock``, ``Bottleneck`` (with its downsample) and the stem (the
  7 x 7 conv at stride 2, BatchNorm, ReLU and the 3 x 3 max pool) at 8
  channels on 8 x 8 inputs, their weights and BatchNorm statistics carried
  from curl_tpu's ``state_dict()`` by ``load_numpy_state_dict``: the
  private output within 0.05 (tests/test_arithmetic.py's conv tolerance)
  of float64 and of curl_tpu's, rounds and bytes equal curl_tpu's, at
  64-bit compares (curl_tpu's readings, its eager forward, in
  tests/golden/torch_resnet_reference.npz, written by
  tests/torch_resnet_reference.py); the port within 0.05 of float64 at the
  default 32 bits too; a BatchNorm at eval keeps its statistics public and
  its weight and bias private;
* ``resnet18/34/50/101``: the names, shapes and order-free key sets of
  their state dicts equal curl_tpu's (torchvision's keys, buffers
  included);
* a whole ResNet-18 on a 3 x 64 x 64 input built as chip_smoke's phase 11
  builds it at 224 (``chip_smoke.build_resnet``): the private logits
  within phase 11's bound of float64, the least-felt block's absence above
  it, and the rounds phase 11 holds the card to.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from curl_tpu import models as jmodels  # noqa: E402

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch import models as tmodels  # noqa: E402
from curl_tpu_torch import nn as tnn  # noqa: E402
from curl_tpu_torch.config import cfg  # noqa: E402
from curl_tpu_torch.models import load_numpy_state_dict  # noqa: E402

from chip_smoke import (BENCH_CONFIG, RESNET_LOGITS_REL_L2, RESNET_ROUNDS,  # noqa: E402
                        build_resnet, resnet_readings)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "torch_resnet_reference.npz")
# the comparison with curl_tpu's readings (tests/torch_resnet_reference.py)
GOLDEN_CONFIG = {"mpc.compare_bits": 64}
F = torch.nn.functional
X = np.random.default_rng(5).normal(size=(1, 8, 8, 8))
STEM_X = np.random.default_rng(6).normal(size=(1, 3, 8, 8))


def _stem(nn):
    return nn.Sequential(nn.Conv2d(3, 8, 7, stride=2, padding=3, bias=False), nn.BatchNorm2d(8),
                         nn.ReLU(), nn.MaxPool2d(3, stride=2, padding=1))


# name -> (the module in either package, input)
MODULES = {
    "basic_block": (lambda nn, models: models.resnet.BasicBlock(8, 8), X),
    "bottleneck": (lambda nn, models: models.resnet.Bottleneck(8, 2, stride=2), X),
    "stem": (lambda nn, models: _stem(nn), STEM_X),
}


def _numpy_state(module, seed):
    """curl_tpu's state dict with its BatchNorm statistics set to a numpy
    seed's draws (means 0.2 N(0, 1), variances in [0.5, 1.5])."""
    rng = np.random.default_rng(seed)
    sd = {k: np.asarray(v, dtype=np.float64) for k, v in module.state_dict().items()}
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = 0.2 * rng.standard_normal(sd[k].shape)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 1.5, sd[k].shape)
        elif k.endswith("bias") or (k.endswith("weight") and sd[k].ndim == 1):
            sd[k] = sd[k] + 0.1 * rng.standard_normal(sd[k].shape)
    module.load_state_dict(sd)
    return sd


def _plain(name, sd, x):
    """The module's float64 forward (BatchNorm at eval)."""
    def t(k):
        return torch.tensor(sd[k])

    def bn(p, h):
        v = (1, -1, 1, 1)
        inv = 1.0 / torch.sqrt(t(p + "running_var") + 1e-5)
        return (h - t(p + "running_mean").view(v)) * inv.view(v) * t(p + "weight").view(v) + t(
            p + "bias").view(v)

    h = torch.tensor(x)
    if name == "stem":
        return F.max_pool2d(F.relu(bn("1.", F.conv2d(h, t("0.weight"), stride=2, padding=3))),
                            3, stride=2, padding=1).numpy()
    if name == "basic_block":
        out = F.relu(bn("bn1.", F.conv2d(h, t("conv1.weight"), padding=1)))
        return F.relu(bn("bn2.", F.conv2d(out, t("conv2.weight"), padding=1)) + h).numpy()
    identity = bn("downsample.1.", F.conv2d(h, t("downsample.0.weight"), stride=2))
    out = F.relu(bn("bn1.", F.conv2d(h, t("conv1.weight"))))
    out = F.relu(bn("bn2.", F.conv2d(out, t("conv2.weight"), stride=2, padding=1)))
    return F.relu(bn("bn3.", F.conv2d(out, t("conv3.weight"))) + identity).numpy()


def _golden(name):
    """(state dict, curl_tpu's decoded output, its rounds and bytes) from
    tests/golden/torch_resnet_reference.npz."""
    with np.load(GOLDEN) as g:
        sd = {k.split("/sd/")[1]: g[k] for k in g.files if k.startswith(f"{name}/sd/")}
        return sd, g[f"{name}/output"], tuple(int(v) for v in g[f"{name}/counts"])


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_like_curl_tpu_and_float64(name):
    """At 64-bit compares, where curl_tpu's max-pool pad is ordered: the
    port's output against curl_tpu's and float64, the rounds and bytes
    curl_tpu's; at the default 32 bits, the port against float64."""
    build, x = MODULES[name]
    sd, want, want_counts = _golden(name)
    ct.init(world_size=2, seed=1234, device="cpu")
    module = build(tnn, tmodels)
    load_numpy_state_dict(module, sd)
    module.encrypt()
    xe = ct.cryptensor(x)
    ref = _plain(name, sd, x)
    with cfg.temp_override(GOLDEN_CONFIG):
        ct.reset_communication_stats()
        got = module(xe).get_plain_text()
        stats = ct.get_communication_stats()
    assert got.shape == ref.shape == want.shape
    np.testing.assert_allclose(got, ref, atol=0.05)
    np.testing.assert_allclose(want, ref, atol=0.05)
    np.testing.assert_allclose(got, want, atol=0.05)
    assert (stats["rounds"], stats["bytes"]) == want_counts
    np.testing.assert_allclose(module(xe).get_plain_text(), ref, atol=0.05)


def test_batchnorm_keeps_statistics_public_and_affine_private():
    ct.init(world_size=2, seed=1, device="cpu")
    bn = tnn.BatchNorm2d(4)
    assert not bn.training  # eval, as curl_tpu's modules start
    bn.encrypt()
    assert isinstance(bn.weight, ct.MPCTensor) and isinstance(bn.bias, ct.MPCTensor)
    assert isinstance(bn.running_mean, torch.Tensor) and isinstance(bn.running_var, torch.Tensor)
    assert list(bn.state_dict()) == ["weight", "bias", "running_mean", "running_var"]
    bn.train()
    x = np.random.default_rng(2).normal(size=(2, 4, 3, 3)) * 2
    got = bn(ct.cryptensor(x)).get_plain_text()
    want = (x - x.mean((0, 2, 3), keepdims=True)) / np.sqrt(x.var((0, 2, 3), keepdims=True) + 1e-5)
    # the private inv_sqrt errs by one factor a channel (ROADMAP's traps):
    # the output is that channel's factor times float64's, up to the
    # protocol's noise
    for c in range(4):
        g, w = got[:, c].ravel(), want[:, c].ravel()
        scale = float(g @ w / (w @ w))
        assert 0.8 < scale < 1.25
        np.testing.assert_allclose(g, scale * w, atol=0.01)


@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50", "resnet101"])
def test_resnet_state_dict_keys_equal_curl_tpu(name):
    with tnn.module.skip_init():
        ours = {k: tuple(v.shape) for k, v in getattr(tmodels, name)().state_dict().items()}
    theirs = {k: tuple(np.shape(v)) for k, v in getattr(jmodels, name)().state_dict().items()}
    assert ours == theirs


def test_resnet18_small_input_against_float64():
    """Phase 11's build (He-normal weights from numpy seed 1234, BatchNorm
    statistics from the float64 forward) of a whole ResNet-18 on a 3 x 64
    x 64 input, under bench.py's kernel configuration: the logits within
    the phase's bound of float64 and the top-1 class kept, the rounds phase
    11 expects at 224 (they do not depend on the input size), the
    least-felt block's absence above the bound."""
    ct.init(world_size=2, seed=11, device="cpu")
    model, _, x, ref, _, plain_fault = build_resnet("resnet18", "cpu", size=64)
    with cfg.temp_override(BENCH_CONFIG):
        ct.reset_communication_stats()
        logits = model(ct.cryptensor(x)).get_plain_text()
        rounds = ct.get_communication_stats()["rounds"]
    err, agree = resnet_readings(logits, ref)
    assert rounds == RESNET_ROUNDS["resnet18"]
    assert err <= RESNET_LOGITS_REL_L2 and agree == 1
    assert plain_fault > RESNET_LOGITS_REL_L2
