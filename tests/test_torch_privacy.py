"""DPSplitModel, the port's split-model training with label DP, against
curl_tpu and float64.

* A small MLP (6 -> 8 -> 3 sigmoid outputs, batch 4, weights, inputs and
  multi-label targets from numpy seeds) through one step of each protocol
  at noise 0 (``DP_CASES``): ``layer_estimation``'s gradients and dL/dZ
  within ``REL_L2`` relative L2 of curl_tpu's, the rounds and bytes of its
  forward and loss and of its backward curl_tpu's; ``full_jacobian``'s
  gradients too, its forward's and loss's rounds and bytes curl_tpu's, its
  backward one private product: curl_tpu multiplies dL/dZ by each
  parameter's Jacobian in public, the port encrypts the whole Jacobian by
  the feature party, as the reference does (ROADMAP Queue C); randomized
  response (flipped targets 0 or 1, curl_tpu's
  rounds and bytes) and RAPPOR's and BCE's loss (within ``LOSS_ATOL`` of
  curl_tpu's and of float64's). Each step's gradients within ``OWN_REL_L2``
  of the float64 backpropagation of its own decrypted dL/dZ, and against
  torch's float64 BCEWithLogits gradient within what the default sigmoid's
  LUT leaves (``BCE_REL_L2``).
* chip_smoke's phase 13 at batch 32: LeNet as a float32 torch model through
  layer_estimation, each gradient within ``LENET_OWN_REL_L2`` of the float64
  backpropagation of its projected dL/dZ; with ``noise_magnitude`` the
  deviation from the noiseless step has the noise's scale, there and over a
  wider MLP's 643 gradients through full_jacobian (LeNet's 62,006-column
  Jacobian takes half a minute a step on a CPU; phase 13 runs it on the
  card).
* ``attach_hooks`` before a layer_estimation step is required;
  ``skip_loss_forward`` leaves the loss a placeholder.

curl_tpu's readings are in ``tests/golden/torch_convert_reference.npz``
(``JAX_PLATFORMS=cpu python3 tests/torch_convert_reference.py``).
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import curl_tpu_torch as ct  # noqa: E402

from chip_smoke import (dp_noise_scale, dp_protocol_reference, dp_step,  # noqa: E402
                        dp_targets, lenet_batch, rel_l2, torch_lenet)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "torch_convert_reference.npz")
SESSION_SEED = 1234
BATCH = 4
# The port against curl_tpu: each gradient's and dL/dZ's relative L2. The
# default (haar) sigmoid reads a LUT cell of 0.5 whose index is truncated
# probabilistically, so a logit takes either neighbouring cell, by each
# package's own draws: at session seed 1234 the two read 0.05-0.09 apart.
# Against the float64 backpropagation of the step's own decrypted dL/dZ
# (the protocol's fixed point alone): 0.0001-0.0004. Against torch's
# float64 BCEWithLogits gradient, where the sigmoid's cells err up to 0.09:
# 0.11. The loss: 0.021 from float64's.
REL_L2 = 0.25
OWN_REL_L2 = 0.02
BCE_REL_L2 = 0.3
LOSS_ATOL = 0.05
# LeNet's layer_estimation at batch 32 solves dL/dZ through pinv(X) of a
# 32 x 84 activation whose smallest singular values amplify the fixed
# point's error: 0.004-0.065 by parameter at session seed 11
LENET_OWN_REL_L2 = 0.1
LENET_BATCH = 32
NOISE = 0.01
RR_PROB = 0.25
RAPPOR_PROB = 0.8
# protocol, DPSplitModel keywords, config overrides
DP_CASES = {
    "layer_estimation": ("layer_estimation", {}, {}),
    "full_jacobian": ("full_jacobian", {}, {}),
    "randomized_response": ("layer_estimation", {"randomized_response_prob": RR_PROB}, {}),
    "rappor": ("layer_estimation", {"rappor_prob": RAPPOR_PROB},
               {"nn.dpsmpc.skip_loss_forward": False}),
    "bce": ("full_jacobian", {}, {"nn.dpsmpc.skip_loss_forward": False}),
}


def small_model():
    """The float32 MLP 6 -> 8 -> 3 with weights from numpy seed 31."""
    net = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.ReLU(), torch.nn.Linear(8, 3))
    rng = np.random.default_rng(31)
    net.load_state_dict({k: torch.as_tensor(rng.normal(size=tuple(v.shape)) * 0.5,
                                            dtype=torch.float32)
                         for k, v in net.state_dict().items()})
    return net


def small_data():
    rng = np.random.default_rng(32)
    return rng.normal(size=(BATCH, 6)), rng.integers(0, 2, (BATCH, 3)).astype(np.float64)


def run_case(pkg, name):
    """One step of case ``name`` in ``pkg`` (either package) on the small
    MLP: {grads by key, dldz, targets, loss (or nan), rounds, bytes}."""
    protocol, kw, config = DP_CASES[name]
    model = small_model()
    x, y = small_data()
    counts = _counts(pkg)
    with pkg.cfg.temp_override(dict(config, **{"nn.dpsmpc.protocol": protocol})):
        dp = pkg.nn.DPSplitModel(model, **kw)
        if protocol == "layer_estimation":
            dp.attach_hooks()
        dp.zero_grad()
        counts.reset_communication_stats()
        dp(x)
        loss = dp.compute_loss(y)
        before = counts.get_communication_stats()
        counts.reset_communication_stats()
        dp.backward()
        after = counts.get_communication_stats()
    return dict(
        grads={k: p.grad.detach().double().numpy() for k, p in model.named_parameters()},
        dldz=np.asarray(dp.dLdZ.get_plain_text()), targets=np.asarray(dp.targets.get_plain_text()),
        loss=float(loss.get_plain_text()) if hasattr(loss, "get_plain_text") else np.nan,
        counts=(before["rounds"], before["bytes"], after["rounds"], after["bytes"]))


def _counts(pkg):
    if pkg is ct:
        from curl_tpu_torch import comm
    else:
        from curl_tpu import comm
    return comm


def own_reference(x, dldz):
    """The float64 gradients backpropagated from ``dldz`` through a float64
    copy of the small model."""
    net = small_model().double()
    out = net(torch.as_tensor(x, dtype=torch.float64))
    grads = torch.autograd.grad(out, list(net.parameters()),
                                grad_outputs=torch.as_tensor(dldz, dtype=torch.float64))
    return {k: g.numpy() for (k, _), g in zip(net.named_parameters(), grads)}


def bce_reference(x, y):
    net = small_model().double()
    loss = torch.nn.functional.binary_cross_entropy_with_logits(
        net(torch.as_tensor(x, dtype=torch.float64)), torch.as_tensor(y))
    grads = torch.autograd.grad(loss, list(net.parameters()))
    return {k: g.numpy() for (k, _), g in zip(net.named_parameters(), grads)}, float(loss)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _init(seed=SESSION_SEED):
    ct.init(world_size=2, seed=seed, device="cpu")


def _want(golden, name):
    g = {k.split("/")[-1]: golden[k] for k in golden if k.startswith(f"dp/{name}/grad/")}
    return g, golden[f"dp/{name}/dldz"], float(golden[f"dp/{name}/loss"]), tuple(
        int(v) for v in golden[f"dp/{name}/counts"])


def jacobian_product_counts(dldz, jacobian):
    """The port's rounds and bytes of one private product of the flat
    dL/dZ by the encrypted Jacobian, alone."""
    from curl_tpu_torch import comm

    a = ct.cryptensor(np.ravel(dldz))
    b = ct.cryptensor(jacobian)
    comm.reset_communication_stats()
    a.matmul(b)
    stats = comm.get_communication_stats()
    return stats["rounds"], stats["bytes"]


@pytest.mark.parametrize("name", list(DP_CASES))
def test_dp_step_like_curl_tpu_and_float64(name, golden):
    _init()
    got = run_case(ct, name)
    grads, dldz, loss, counts = _want(golden, name)
    x, y = small_data()
    own = own_reference(x, got["dldz"])
    bce, bce_loss = bce_reference(x, y)
    for k, g in got["grads"].items():
        assert np.isfinite(g).all()
        assert rel_l2(g, own[k]) <= OWN_REL_L2, k
        if name != "randomized_response":  # the flips are each package's draws
            assert rel_l2(g, grads[k]) <= REL_L2, k
            assert rel_l2(g, bce[k]) <= BCE_REL_L2, k
    if name == "randomized_response":
        np.testing.assert_allclose(got["targets"], np.round(got["targets"]), atol=1e-3)
        assert set(np.round(got["targets"]).ravel()) <= {0.0, 1.0}
    else:
        np.testing.assert_allclose(got["targets"], y)
        assert rel_l2(got["dldz"], dldz) <= REL_L2
    # the forward and the loss as curl_tpu's; layer_estimation's backward
    # too. curl_tpu's full_jacobian multiplies dL/dZ by each parameter's
    # Jacobian in public (a truncation each); the port's backward is one
    # private product by the Jacobian encrypted by the feature party
    assert got["counts"][:2] == counts[:2]
    if DP_CASES[name][0] == "full_jacobian":
        z, p = BATCH * 3, sum(v.size for v in got["grads"].values())
        assert got["counts"][2:] == jacobian_product_counts(got["dldz"], np.ones((z, p)))
    else:
        assert got["counts"][2:] == counts[2:]
    if name in ("rappor", "bce"):
        p = 1 / (1 + np.exp(-(small_model().double()(torch.as_tensor(x)).detach().numpy())))
        if name == "rappor":
            p = RAPPOR_PROB * p + (1 - RAPPOR_PROB) * (1 - p)
            want64 = -np.mean(y * np.log(p) + (1 - y) * np.log(1 - p))
        else:
            want64 = bce_loss
        assert abs(got["loss"] - loss) <= LOSS_ATOL
        assert abs(got["loss"] - want64) <= LOSS_ATOL
    else:
        assert np.isnan(got["loss"]) and np.isnan(loss)


def test_lenet_layer_estimation_and_noise_scale():
    """chip_smoke's phase 13 path at batch 32: LeNet's layer_estimation
    step within LENET_OWN_REL_L2 of the float64 backpropagation of its projected
    dL/dZ; with noise, the deviation of the last Linear's weight gradient
    within 15% of the noise's share that reaches it (320 degrees of
    freedom, 4% standard error)."""
    _init(11)
    x, _ = lenet_batch(LENET_BATCH)
    y = dp_targets(LENET_BATCH)
    model = torch_lenet("cpu")
    clean, dp = dp_step(ct, model, x, y, "layer_estimation")
    own = dp_protocol_reference(dp, x, "cpu")
    for k in clean:
        assert rel_l2(clean[k], own[k]) <= LENET_OWN_REL_L2, k
    noisy, dp = dp_step(ct, model, x, y, "layer_estimation", noise=NOISE)
    got, want = dp_noise_scale(dp, "layer_estimation", noisy, clean, noise=NOISE)
    assert 0.85 * want <= got <= 1.15 * want


def wide_model():
    """A float32 MLP 6 -> 64 -> 3 (643 parameters) from numpy seed 33."""
    net = torch.nn.Sequential(torch.nn.Linear(6, 64), torch.nn.ReLU(), torch.nn.Linear(64, 3))
    rng = np.random.default_rng(33)
    net.load_state_dict({k: torch.as_tensor(rng.normal(size=tuple(v.shape)) * 0.3,
                                            dtype=torch.float32)
                         for k, v in net.state_dict().items()})
    return net


def test_full_jacobian_noise_scale():
    """full_jacobian's noise lands on every parameter's gradient: over 643
    parameters the deviation from the noiseless step has standard deviation
    within 15% of noise_magnitude (2.8% standard error)."""
    _init(11)
    x, y = small_data()
    model = wide_model()
    clean, _ = dp_step(ct, model, x, y, "full_jacobian")
    noisy, dp = dp_step(ct, model, x, y, "full_jacobian", noise=NOISE)
    got, want = dp_noise_scale(dp, "full_jacobian", noisy, clean, noise=NOISE)
    assert want == NOISE and 0.85 * want <= got <= 1.15 * want


def test_layer_estimation_needs_hooks_and_skipped_loss():
    _init()
    model = small_model()
    x, y = small_data()
    dp = ct.nn.DPSplitModel(model)
    dp(x)
    loss = dp.compute_loss(y)
    assert "skipped" in repr(loss)
    with pytest.raises(RuntimeError):
        dp.backward()
    with pytest.raises(AssertionError):
        ct.nn.DPSplitModel(model, randomized_response_prob=0.5)
