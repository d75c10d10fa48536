"""Private training with the port: examples/mpc_cifar.py's LeNet step.

* One training step of LeNet (chip_smoke's ``build_lenet``, 3 x 32 x 32,
  10 classes) at batch 2, weights from a numpy state dict
  (``chip_smoke.lenet_state``) that both packages load, against curl_tpu's
  readings of the same step (``tests/golden/torch_train_reference.npz``,
  written by ``tests/torch_train_reference.py lenet``): the loss within
  ``LOSS_ATOL`` of curl_tpu's, each parameter's gradient within
  ``GRAD_REL_L2`` (conv1's bias ``BIAS0_REL_L2``) relative L2 of
  curl_tpu's and of float64's, and the
  rounds and bytes of the forward and backward, and of the whole step with
  SGD, equal to curl_tpu's.
* The step through ``compile_parties`` (eager on a CPU session, from the
  first call's draw counter): bit-identical to the same step run eagerly
  at its keys and counter, the same CommStats, the caller's parameters
  untouched, and the next call trained on from its output.
* ``no_grad`` and ``enable_grad``; ``detach`` (chip_smoke's planted fault)
  leaves conv1 without a gradient.
* A seed-compressed weight that requires grad raises as it enters the
  tape, in the port and in curl_tpu (one of the two tests here that run
  curl_tpu live); a frozen one lets the input's gradient through.
* The Module training surface: ``named_parameters`` (names and order
  curl_tpu's, the other live test), ``parameters``, ``zero_grad``,
  ``update_parameters`` with its threshold, ``decrypt``,
  ``load_state_dict``, ``train``/``eval``; the losses and the init
  functions.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch import nn, optim  # noqa: E402
from curl_tpu_torch.nn import init  # noqa: E402

from chip_smoke import (build_lenet, lenet_batch, lenet_forward, lenet_grads,  # noqa: E402
                        lenet_model, lenet_params, lenet_state, lenet_train_fn,
                        plain_lenet_trajectory, rel_l2, runner_shares)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "torch_train_reference.npz")
BATCH = 2
LR = 0.01
REFERENCE_SEED = 1215
# the port against curl_tpu's readings (and each against float64's) at
# batch 2: each gradient's relative L2 and the loss's absolute error. The
# port read 0.0007-0.0147 from curl_tpu and 0.0046-0.0103 from float64
# (curl_tpu 0.0045-0.0112) for every parameter but conv1's bias, a sum of
# 1568 terms a few fixed-point units each: 0.1225 from curl_tpu, 0.1104
# from float64 (curl_tpu 0.0707); the losses within 0.0007 of each other
GRAD_REL_L2 = 0.03
BIAS0_REL_L2 = 0.2
LOSS_ATOL = 0.005


def _init(seed=REFERENCE_SEED):
    ct.init(world_size=2, seed=seed, device="cpu")


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port_step():
    return reference_step()


def reference_step():
    """The port's step at batch 2, as tests/torch_train_reference.py runs
    curl_tpu's: (loss, gradients, forward-and-backward counts, step counts,
    float64's loss and gradients)."""
    _init()
    x, labels = lenet_batch(BATCH)
    sd = lenet_state()
    model = lenet_model(ct, sd)
    opt = optim.SGD(list(model.parameters()), lr=LR)
    xe = ct.cryptensor(x)
    ct.reset_communication_stats()
    opt.zero_grad()
    loss = nn.CrossEntropyLoss()(model(xe), labels)
    loss.backward()
    backward = ct.get_communication_stats()
    opt.step()
    step = ct.get_communication_stats()
    losses64, grads64, _ = plain_lenet_trajectory(sd, x, labels, "cpu", 1, lr=LR)
    return dict(loss=float(loss.get_plain_text()), grads=lenet_grads(model),
                counts=(backward["rounds"], backward["bytes"]),
                step_counts=(step["rounds"], step["bytes"]), loss64=losses64[0], grads64=grads64)


def test_lenet_step_counts_equal_curl_tpu(port_step, golden):
    assert port_step["counts"] == tuple(golden["counts"])
    assert port_step["step_counts"] == tuple(golden["step_counts"])


def test_lenet_loss_against_curl_tpu_and_float64(port_step, golden):
    assert abs(port_step["loss"] - float(golden["loss"])) <= LOSS_ATOL
    assert abs(port_step["loss"] - port_step["loss64"]) <= LOSS_ATOL
    assert abs(float(golden["loss"]) - port_step["loss64"]) <= LOSS_ATOL


@pytest.mark.parametrize("key", ["0.weight", "0.bias", "3.weight", "3.bias", "7.weight",
                                 "7.bias", "9.weight", "9.bias", "11.weight", "11.bias"])
def test_lenet_gradient_against_curl_tpu_and_float64(port_step, golden, key):
    got = port_step["grads"][key]
    ref = golden[f"grad/{key}"].astype(np.float64)
    bound = BIAS0_REL_L2 if key == "0.bias" else GRAD_REL_L2
    assert got.shape == ref.shape
    assert rel_l2(got, ref) <= bound, rel_l2(got, ref)
    assert rel_l2(got, port_step["grads64"][key]) <= bound
    assert rel_l2(ref, port_step["grads64"][key]) <= bound


def test_compiled_step_equals_eager_step():
    """compile_parties over the training step (tests/test_compiled.py:30):
    the first call bit-identical to the step run eagerly under its keys
    from its draw counter, with its CommStats; the caller's parameters
    untouched; the next call trains on from the first's output."""
    from curl_tpu_torch import random as crandom

    _init(7)
    x, labels = lenet_batch(BATCH)
    labels = torch.as_tensor(labels)  # a tensor argument, read in place
    model = lenet_model(ct, lenet_state())
    xe = ct.cryptensor(x)
    fn = lenet_train_fn(ct, model, lr=LR)
    params = model.params_pytree()
    before = [t.clone() for t in runner_shares(params)]
    step = ct.compile_parties(fn, 2)
    ct.reset_communication_stats()
    p1, loss1 = step(101, params, xe, labels)
    stats = ct.get_communication_stats()
    assert all(torch.equal(a, b) for a, b in zip(before, runner_shares(params)))
    assert all(t.grad is None for t in model.parameters()) or all(
        t.grad is None for t in (v for sub in params.values() if isinstance(sub, dict)
                                 for v in sub.get("__params__", {}).values()))

    leaves = []
    spec = ct.parallel.runner._flatten((params, xe, labels), leaves)
    fresh = ct.parallel.runner._build(spec, leaves, public=True)
    resume = crandom.counter()
    crandom.set_counter(step.counter)
    ct.reset_communication_stats()
    with ct.parallel.mpc_context(crandom.make_party_keys(101, 2), 2):
        p_eager, loss_eager = fn(*fresh)
    crandom.set_counter(resume)
    eager_stats = ct.get_communication_stats()
    assert torch.equal(loss1.share, loss_eager.share)
    assert all(torch.equal(a, b) for a, b in zip(runner_shares(p1), runner_shares(p_eager)))
    assert (stats["rounds"], stats["bytes"]) == (eager_stats["rounds"], eager_stats["bytes"])
    assert step.stats["rounds"] == stats["rounds"] > 0

    p2, loss2 = step(102, p1, xe, labels)
    assert float(loss2.get_plain_text()) < float(loss1.get_plain_text())
    moved = {k: rel_l2(v, lenet_params(p1)[k]) for k, v in lenet_params(p2).items()}
    assert min(moved.values()) > 0


def test_no_grad_records_nothing():
    _init(3)
    x = ct.cryptensor(np.array([[1.0, -2.0], [0.5, 3.0]]), requires_grad=True)
    with ct.no_grad():
        assert not ct.is_grad_enabled()
        y = (x * x + x).relu().sum()
        assert not y.requires_grad and y.grad_fn is None
        with ct.enable_grad():
            z = x.square().sum()
        assert z.requires_grad and z.grad_fn is not None
    assert ct.is_grad_enabled()
    z.backward()
    np.testing.assert_allclose(x.grad.get_plain_text(), 2 * np.array([[1.0, -2.0], [0.5, 3.0]]),
                               atol=0.02)


def test_operators_record_and_fan_out_accumulates():
    """``a * b + a`` through the rebound dunders: a's gradient sums its
    two uses; a second backward adds into ``grad``."""
    _init(4)
    a = ct.cryptensor(np.array([1.0, 2.0, -1.0]), requires_grad=True)
    b = ct.cryptensor(np.array([0.5, -1.0, 3.0]), requires_grad=True)
    (a * b + a).sum().backward()
    np.testing.assert_allclose(a.grad.get_plain_text(), [1.5, 0.0, 4.0], atol=0.02)
    np.testing.assert_allclose(b.grad.get_plain_text(), [1.0, 2.0, -1.0], atol=0.02)
    (a - 2.0).sum().backward()
    np.testing.assert_allclose(a.grad.get_plain_text(), [2.5, 1.0, 5.0], atol=0.02)
    d = a.detach()
    assert not d.requires_grad and d.grad_fn is None


def test_planted_fault_leaves_conv1_without_gradient():
    _init(5)
    x, labels = lenet_batch(BATCH)
    model = lenet_model(ct, lenet_state())
    loss = nn.CrossEntropyLoss()(lenet_forward(model, ct.cryptensor(x), detach_before=3), labels)
    loss.backward()
    grads = lenet_grads(model)
    assert model[0].weight.grad is None and model[0].bias.grad is None
    assert not np.any(grads["0.weight"]) and np.any(grads["3.weight"])


def _compressed(value, key=2):
    from curl_tpu_torch.mpc.mpc import MPCTensor
    from curl_tpu_torch.mpc.primitives.compressed import SeedCompressedArithmetic

    return MPCTensor(SeedCompressedArithmetic.encrypt(torch.as_tensor(value), key))


def test_backward_through_compressed_raises():
    """tests/test_compressed.py:165-195 in the port: a compressed weight
    that requires grad raises as it enters the tape; a frozen one lets the
    input's gradient through (d sum(x @ I) / dx = 1)."""
    _init(6)
    w = _compressed(np.ones((3, 3)))
    w.requires_grad = True
    x = ct.cryptensor(np.ones((3, 3)))
    with pytest.raises(RuntimeError, match="seed-compressed"):
        x.matmul(w)
    frozen = _compressed(np.eye(3), key=3)
    x = ct.cryptensor(np.ones((2, 3)), requires_grad=True)
    x.matmul(frozen).sum().backward()
    np.testing.assert_allclose(x.grad.get_plain_text(), np.ones((2, 3)), atol=0.02)


def test_curl_tpu_raises_the_same_on_a_compressed_weight():
    """curl_tpu live: the same refusal, the same words."""
    import jax

    import curl_tpu
    from curl_tpu.mpc.mpc import MPCTensor
    from curl_tpu.mpc.primitives.compressed import SeedCompressedArithmetic

    curl_tpu.init(world_size=2, seed=8)
    w = MPCTensor(SeedCompressedArithmetic.encrypt(np.ones((3, 3)), jax.random.PRNGKey(2)))
    w.requires_grad = True
    x = curl_tpu.cryptensor(np.ones((3, 3))).mpc
    with pytest.raises(RuntimeError, match="seed-compressed"):
        x.matmul(w)


def test_module_training_surface_names_curl_tpus():
    """curl_tpu live (its module, no MPC): LeNet's parameter names in
    curl_tpu's order, and the port's surface over them."""
    from curl_tpu import nn as jnn

    _init(9)
    jnames = [k for k, _ in build_lenet(jnn).named_parameters()]
    model = build_lenet(nn)
    assert [k for k, _ in model.named_parameters()] == jnames
    assert [tuple(p.shape) for p in model.parameters()] == [
        tuple(np.shape(v)) for v in lenet_state().values()]
    assert list(model.named_parameters(prefix="net"))[0][0] == "net.0.weight"

    sd = lenet_state()
    model.load_state_dict(sd)
    model.encrypt(src=0, requires_grad=True)
    assert all(p.requires_grad for p in model.parameters())
    for p in model.parameters():
        p.grad = ct.cryptensor(np.full(p.shape, 0.5))
    model[7].weight.grad = ct.cryptensor(np.full(model[7].weight.shape, 200.0))
    old = model[7].weight
    model.update_parameters(0.1)  # grad_threshold 100: the 200s are zeroed
    assert model[7].weight is not old and model[7].weight.requires_grad
    model.zero_grad()
    assert all(p.grad is None for p in model.parameters())
    model.train()
    assert all(m.training for m in model.modules())
    model.eval()
    assert not any(m.training for m in model.modules())
    model.decrypt()
    plain = dict(model.named_parameters())
    np.testing.assert_allclose(plain["7.weight"].numpy(), sd["7.weight"], atol=1e-4)
    np.testing.assert_allclose(plain["0.weight"].numpy(), sd["0.weight"] - 0.05, atol=1e-4)
    with pytest.raises(KeyError):
        model.load_state_dict({"0.weight": sd["0.weight"]})


@pytest.mark.parametrize("name", ["MSELoss", "L1Loss", "BCELoss", "BCEWithLogitsLoss",
                                  "CrossEntropyLoss", "RAPPORLoss", "CosineSimilarity"])
def test_losses_against_float64(name):
    """Each loss module's value and input gradient against float64, within
    the tolerances of curl_tpu's sweep for the functions they compose; the
    CosineSimilarity module's gradient against float64's with the norms
    held constant, as curl_tpu's module computes it (ROADMAP Queue C)."""
    F = torch.nn.functional
    _init(10)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, 5))
    y = rng.normal(size=(4, 5))
    if name in ("BCELoss", "RAPPORLoss"):
        x = rng.uniform(0.15, 0.85, size=(4, 5))
    if name in ("BCELoss", "BCEWithLogitsLoss", "RAPPORLoss"):
        y = (rng.uniform(size=(4, 5)) > 0.5).astype(np.float64)
    if name == "CrossEntropyLoss":
        y = np.eye(5)[rng.integers(0, 5, 4)]
    tx = torch.tensor(x, requires_grad=True)
    ty = torch.tensor(y)
    plain = {
        "MSELoss": lambda: F.mse_loss(tx, ty),
        "L1Loss": lambda: F.l1_loss(tx, ty),
        "BCELoss": lambda: F.binary_cross_entropy(tx, ty),
        "BCEWithLogitsLoss": lambda: F.binary_cross_entropy_with_logits(tx, ty),
        "CrossEntropyLoss": lambda: -(ty * F.log_softmax(tx, -1)).sum() / 4,
        "RAPPORLoss": lambda: F.binary_cross_entropy(0.7 * tx + 0.3 * (1 - tx), ty),
        # curl_tpu's module takes the norms' inv_sqrt off the tape
        # (distances.py:19-23), so its gradient treats them as constants
        "CosineSimilarity": lambda: ((tx * ty).sum(1) / (tx.norm(dim=1) * ty.norm(dim=1)).detach()
                                     ).sum(),
    }[name]()
    plain.backward()
    module = nn.RAPPORLoss(0.7) if name == "RAPPORLoss" else getattr(nn, name)()
    xe = ct.cryptensor(x, requires_grad=True)
    target = ct.cryptensor(y) if name == "CosineSimilarity" else y
    out = module(xe, target)
    if name == "CosineSimilarity":
        out = out.sum()
    out.backward()
    tol = {"MSELoss": 0.02, "L1Loss": 0.02, "CosineSimilarity": 0.15}.get(name, 0.25)
    np.testing.assert_allclose(out.get_plain_text(), plain.item(), atol=tol)
    np.testing.assert_allclose(xe.grad.get_plain_text(), tx.grad.numpy(), atol=tol)


@pytest.mark.parametrize("fn,args,fan_in,std", [
    ("kaiming_uniform_", {}, 75, np.sqrt(2.0 / 75)),
    ("kaiming_normal_", {}, 75, np.sqrt(2.0 / 75)),
    ("xavier_uniform_", {}, 75, np.sqrt(2.0 / (75 + 150))),
    ("xavier_normal_", {}, 75, np.sqrt(2.0 / (75 + 150))),
    ("uniform_", {"a": -0.5, "b": 0.5}, None, 1 / np.sqrt(12)),
    ("normal_", {"mean": 0.25, "std": 0.5}, None, 0.5),
])
def test_init_fans_and_moments(fn, args, fan_in, std):
    """curl_tpu/nn/init.py's distributions, drawn from the session's
    generator: their fans and moments (never their values, which come from
    JAX keys there)."""
    _init(12)
    shape = (6, 3, 5, 5)
    w = getattr(init, fn)(shape, **args)
    assert w.shape == shape and w.dtype == torch.float64
    if fan_in is not None:
        assert init._fan(shape) == (fan_in, 150)
    assert abs(float(w.std()) - std) < 0.1 * std
    assert abs(float(w.mean()) - args.get("mean", 0.0)) < 0.25 * std
    _init(12)
    assert torch.equal(getattr(init, fn)(shape, **args), w)
    assert torch.equal(init.constant_((2, 2), 0.5), torch.full((2, 2), 0.5, dtype=torch.float64))
