"""curl_tpu's training readings that the port's tests hold it to, where
running curl_tpu in the tests would take too long (its eager autograd
takes seconds to minutes a case on a CPU).

    JAX_PLATFORMS=cpu python3 tests/torch_train_reference.py autograd [--part K/N] [--only A,B]
    JAX_PLATFORMS=cpu python3 tests/torch_train_reference.py merge
    JAX_PLATFORMS=cpu python3 tests/torch_train_reference.py faults
    JAX_PLATFORMS=cpu python3 tests/torch_train_reference.py lenet

``autograd`` runs every case of tests/test_torch_autograd.py's ``CASES``
(or every N-th from the K-th, into a part file beside the golden, for
running parts side by side; ``merge`` joins the parts; ``--only`` reads
the named cases anew into the existing file) through curl_tpu's
eager forward and ``backward``, each under ``curl_tpu.init(world_size=2,
seed=crc32(name))``, and writes ``tests/golden/torch_autograd_reference.npz``:
each case's decoded outputs and input gradients, and the rounds and bytes
of its forwards and backwards; the same for each probe of ``FAULTS`` (the
gradients of curl_tpu's that are not float64's), under ``faults/``;
``faults`` reads only those anew into the existing file.

``lenet`` runs one training step of tests/test_torch_train.py's LeNet
(examples/mpc_cifar.py's model; its weights, input and labels from the
numpy seeds there, batch 2) through curl_tpu, as
examples/mpc_cifar.py:run_training_step does: ``zero_grad``, the forward,
``CrossEntropyLoss`` on one-hot labels, ``backward``, ``SGD(lr=0.01)``;
and writes ``tests/golden/torch_train_reference.npz``: the loss, every
parameter's gradient (float32), the rounds and bytes of the forward and
backward, and of the step. Run from the repo's root.
"""

import argparse
import glob
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
AUTOGRAD = os.path.join(GOLDEN_DIR, "torch_autograd_reference.npz")
TRAIN = os.path.join(GOLDEN_DIR, "torch_train_reference.npz")


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def autograd_cases(part, only=None):
    _jax()
    import curl_tpu
    from curl_tpu import comm as jcomm
    from curl_tpu.autograd import apply_function
    from test_torch_autograd import CASES, Lib, run_case

    lib = Lib(curl_tpu, jcomm, apply_function)
    k, n = part
    names = sorted(CASES)[k::n] if only is None else only
    out = {}
    if only is not None:
        with np.load(AUTOGRAD) as z:
            out = {key: z[key] for key in z.files if key.split("/")[0] not in only}
    for name in names:
        t0 = time.time()
        readings, counts, _ = run_case(lib, name,
                                       lambda seed: curl_tpu.init(world_size=2, seed=seed))
        for key, v in readings.items():
            out[f"{name}/{key}"] = v
        out[f"{name}/counts"] = np.array(counts)
        print(f"{name}: {counts} in {time.time() - t0:.1f} s", flush=True)
    if k == 0 and only is None:
        out.update(fault_probes(lib))
    path = AUTOGRAD if n == 1 else AUTOGRAD.replace(".npz", f".part{k}of{n}.npz")
    np.savez_compressed(path, **out)


def fault_probes(lib):
    import curl_tpu
    from test_torch_autograd import FAULTS, run_case

    out = {}
    for name in FAULTS:
        readings, counts, _ = run_case(lib, name, lambda seed: curl_tpu.init(
            world_size=2, seed=seed), table=FAULTS)
        for key, v in readings.items():
            out[f"faults/{name}/{key}"] = v
        out[f"faults/{name}/counts"] = np.array(counts)
        print(f"fault probe {name}: {counts}", flush=True)
    return out


def faults():
    """Only the fault probes, read anew into the existing golden."""
    _jax()
    import curl_tpu
    from curl_tpu import comm as jcomm
    from curl_tpu.autograd import apply_function
    from test_torch_autograd import Lib

    with np.load(AUTOGRAD) as z:
        out = {k: z[k] for k in z.files if not k.startswith("faults/")}
    out.update(fault_probes(Lib(curl_tpu, jcomm, apply_function)))
    np.savez_compressed(AUTOGRAD, **out)


def merge():
    parts = sorted(glob.glob(AUTOGRAD.replace(".npz", ".part*of*.npz")))
    out = {}
    for p in parts:
        with np.load(p) as z:
            out.update({k: z[k] for k in z.files})
    np.savez_compressed(AUTOGRAD, **out)
    for p in parts:
        os.remove(p)
    print(f"{len(parts)} parts, {len(out)} arrays")


def lenet():
    _jax()
    import curl_tpu
    from curl_tpu import comm as jcomm
    from curl_tpu import nn, optim
    from test_torch_train import (BATCH, LR, REFERENCE_SEED, build_lenet, lenet_batch,
                                  lenet_state)

    curl_tpu.init(world_size=2, seed=REFERENCE_SEED)
    model = build_lenet(nn)
    model.load_state_dict(lenet_state())
    model.encrypt(src=0)
    params = [p for _, p in model.named_parameters()]
    for p in params:
        p.requires_grad = True
    opt = optim.SGD(params, lr=LR)
    x, labels = lenet_batch(BATCH)
    xe = curl_tpu.cryptensor(x)
    t0 = time.time()
    jcomm.reset_communication_stats()
    opt.zero_grad()
    loss = nn.CrossEntropyLoss()(model(xe), labels)
    loss.backward()
    backward = jcomm.get_communication_stats()
    opt.step()
    step = jcomm.get_communication_stats()
    print(f"step in {time.time() - t0:.1f} s; forward and backward {backward['rounds']} rounds "
          f"{backward['bytes']} bytes; with SGD {step['rounds']} rounds {step['bytes']} bytes",
          flush=True)
    out = {"loss": np.asarray(loss.get_plain_text(), dtype=np.float64),
           "counts": np.array([backward["rounds"], backward["bytes"]]),
           "step_counts": np.array([step["rounds"], step["bytes"]])}
    for name, p in model.named_parameters():
        out[f"grad/{name}"] = np.asarray(p.grad.get_plain_text(), dtype=np.float32)
    np.savez_compressed(TRAIN, **out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["autograd", "merge", "faults", "lenet"])
    ap.add_argument("--part", default="0/1", help="K/N: every N-th case from the K-th")
    ap.add_argument("--only", default=None,
                    help="comma-separated cases read anew into the existing golden")
    args = ap.parse_args()
    if args.what == "autograd":
        autograd_cases(tuple(int(v) for v in args.part.split("/")),
                       None if args.only is None else args.only.split(","))
    elif args.what == "merge":
        merge()
    elif args.what == "faults":
        faults()
    else:
        lenet()


if __name__ == "__main__":
    main()
