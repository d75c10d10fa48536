"""The port's optimizer (``curl_tpu_torch.optim``) against torch's, as
``tests/test_optim.py`` holds curl_tpu's: SGD's trajectory step for step
against ``torch.optim.SGD`` on the same plaintext parameters and gradients
over the momentum, Nesterov, dampening and weight-decay grid, within the
fixed-point tolerance 0.02; the hyperparameter errors; ``grad_threshold``;
``zero_grad`` over parameter groups; the in-place swap of a parameter's
shares; a Linear model trained by SGD on MSELoss reaching the least-squares
weights; and a step's rounds and bytes equal to those of its ops. The
rounds and bytes of a whole training step against curl_tpu's are
tests/test_torch_train.py's."""

import numpy as np
import pytest
import torch

import curl_tpu_torch as ct
from curl_tpu_torch import nn, optim
from curl_tpu_torch.autograd import no_grad

KW = [
    {"lr": 0.1},
    {"lr": 0.1, "momentum": 0.9},
    {"lr": 0.1, "momentum": 0.9, "nesterov": True},
    {"lr": 0.1, "momentum": 0.5, "dampening": 0.3},
    {"lr": 0.05, "weight_decay": 0.1},
    {"lr": 0.1, "momentum": 0.9, "weight_decay": 0.05},
]
IDS = ["plain", "momentum", "nesterov", "dampening", "wd", "momentum+wd"]


@pytest.fixture(autouse=True)
def _session():
    ct.init(world_size=2, seed=31, device="cpu")


def _torch_trajectory(p0, grads, steps, **kw):
    tp = torch.nn.Parameter(torch.tensor(p0))
    opt = torch.optim.SGD([tp], **kw)
    out = []
    for s in range(steps):
        opt.zero_grad()
        tp.grad = torch.tensor(grads[s])
        opt.step()
        out.append(tp.detach().numpy().copy())
    return out


@pytest.mark.parametrize("kw", KW, ids=IDS)
def test_sgd_matches_torch(kw):
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(4, 3))
    grads = [rng.normal(size=(4, 3)) * 0.5 for _ in range(4)]
    ref = _torch_trajectory(p0, grads, 4, **kw)

    p = ct.cryptensor(p0, requires_grad=True)
    opt = optim.SGD([p], **kw)
    with no_grad():
        for s in range(4):
            p.grad = ct.cryptensor(grads[s])
            opt.step()
            np.testing.assert_allclose(p.get_plain_text(), ref[s], atol=0.02,
                                       err_msg=f"diverged from torch at step {s}")


def test_sgd_rejects_bad_hyperparams():
    p = ct.cryptensor(np.zeros(2), requires_grad=True)
    with pytest.raises(ValueError):
        optim.SGD([p], lr=-1.0)
    with pytest.raises(ValueError):
        optim.SGD([p], lr=0.1, momentum=-0.5)
    with pytest.raises(ValueError):
        optim.SGD([p], lr=0.1, weight_decay=-0.1)
    with pytest.raises(ValueError):
        optim.SGD([p], lr=0.1, nesterov=True)  # needs momentum
    with pytest.raises(ValueError):
        optim.SGD([p], lr=0.1, momentum=0.9, dampening=0.1, nesterov=True)
    with pytest.raises(ValueError):
        optim.SGD([], lr=0.1)


def test_grad_threshold_zeroes_exploding_entries():
    g = np.array([0.1, -0.2, 5.0, -7.0])  # the last two exceed the threshold 1.0
    p = ct.cryptensor(np.zeros(4), requires_grad=True)
    opt = optim.SGD([p], lr=1.0, grad_threshold=1.0)
    with no_grad():
        p.grad = ct.cryptensor(g)
        opt.step()
    out = p.get_plain_text()
    np.testing.assert_allclose(out[:2], -g[:2], atol=0.02)
    np.testing.assert_allclose(out[2:], 0.0, atol=0.02)


def test_zero_grad_and_param_groups():
    p1 = ct.cryptensor(np.ones(3), requires_grad=True)
    p2 = ct.cryptensor(np.zeros(3), requires_grad=True)
    p3 = ct.cryptensor(np.zeros(2), requires_grad=True)
    opt = optim.SGD([p1, p2], lr=0.1)
    opt.add_param_group({"params": p3, "lr": 0.5})
    for p in (p1, p2, p3):
        p.grad = ct.cryptensor(np.ones(p.shape))
    opt.zero_grad()
    assert p1.grad is None and p2.grad is None and p3.grad is None
    assert len(opt.param_groups) == 2
    assert len(opt.param_groups[0]["params"]) == 2
    assert opt.param_groups[1]["lr"] == 0.5 and opt.param_groups[1]["momentum"] == 0
    # groups given as dicts, each with its own learning rate
    grouped = optim.SGD([{"params": [p1]}, {"params": [p2], "lr": 1.0}], lr=0.1)
    with no_grad():
        p1.grad = ct.cryptensor(np.ones(3))
        p2.grad = ct.cryptensor(np.ones(3))
        grouped.step()
    np.testing.assert_allclose(p1.get_plain_text(), 0.9, atol=0.02)
    np.testing.assert_allclose(p2.get_plain_text(), -1.0, atol=0.02)


def test_step_swaps_the_shares_in_place():
    """The optimizer keeps the parameter objects: a step replaces the
    shares the same MPCTensor holds (sgd.py:74-82), so a model's registry
    and the optimizer see the update."""
    model = nn.Linear(3, 2)
    model.encrypt(src=0, requires_grad=True)
    w = model.weight
    before = w.get_plain_text()
    opt = optim.SGD(model.parameters(), lr=0.5)
    with no_grad():
        for p in model.parameters():
            p.grad = ct.cryptensor(np.ones(p.shape))
    opt.step()
    assert model.weight is w
    np.testing.assert_allclose(w.get_plain_text(), before - 0.5, atol=0.02)


def test_step_counts_are_its_ops():
    """A step costs what its ops cost, no more: a plain step the public
    product by lr (its truncation), a guarded one the square, the
    comparison and the product by the mask too."""
    p = ct.cryptensor(np.zeros((4, 3)), requires_grad=True)
    with no_grad():
        p.grad = ct.cryptensor(np.ones((4, 3)))
        ct.reset_communication_stats()
        optim.SGD([p], lr=0.1).step()
        plain = ct.get_communication_stats()
        ct.reset_communication_stats()
        p.grad.mul(0.1)
        product = ct.get_communication_stats()
        ct.reset_communication_stats()
        optim.SGD([p], lr=0.1, grad_threshold=1.0).step()
        guarded = ct.get_communication_stats()
        ct.reset_communication_stats()
        g = p.grad
        g.mul(g.square().lt(1.0)).mul(0.1)
        by_hand = ct.get_communication_stats()
    assert (plain["rounds"], plain["bytes"]) == (product["rounds"], product["bytes"])
    assert plain["rounds"] >= 1
    assert (guarded["rounds"], guarded["bytes"]) == (by_hand["rounds"], by_hand["bytes"])


def test_module_training_with_optimizer_converges():
    """Linear regression trained by the encrypted SGD reaches the least-
    squares solution (tests/test_optim.py's end-to-end check)."""
    rng = np.random.default_rng(5)
    w_true = np.array([[1.5, -2.0]])
    x = rng.normal(size=(32, 2))
    y = x @ w_true.T

    model = nn.Linear(2, 1)
    model.encrypt(src=0, requires_grad=True)
    opt = optim.SGD(model.parameters(), lr=0.2, momentum=0.5)
    loss_fn = nn.MSELoss()
    for _ in range(30):
        loss = loss_fn(model(ct.cryptensor(x)), ct.cryptensor(y))
        model.zero_grad()
        loss.backward()
        opt.step()
    model.decrypt()
    np.testing.assert_allclose(model.weight.numpy(), w_true, atol=0.15)
