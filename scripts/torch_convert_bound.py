"""CPU readings behind chip_smoke.py's phase 13 bounds and round counts.

    python3 scripts/torch_convert_bound.py resnet --size 192 --seed 11
    python3 scripts/torch_convert_bound.py dp --seed 11

``resnet``: chip_smoke's torchvision-layout ResNet-18 (``TorchResNet``,
phase 11's weights and input at a reduced size, float64) converted by
``from_pytorch`` and, from ``export_onnx_bytes`` with torch's constant
folding (each BatchNorm folded into its convolution) and without it, by
``from_onnx``; each run unencrypted and privately under bench.py's kernel
configuration, 2 parties. One JSON line a route: rounds and bytes, the
private logits' relative L2 error against the torch model in float64, the
top-1 agreement, the plaintext graph's error and the module count.

``dp``: one DPSplitModel step of each protocol over examples/mpc_cifar.py's
LeNet at batch 64 (chip_smoke's phase 13 inputs), noise 0: each parameter's
gradient's relative L2 error against torch's float64 BCEWithLogits
gradient, and against the float64 backpropagation of the step's own
decrypted dL/dZ (the protocol's error alone), rounds and bytes; then the same with noise_magnitude DP_NOISE:
the deviation's standard deviation against the expected one.

These are CPU runs, never device numbers: resnet about 6 minutes at 192 x
192 on 3 cores, dp about a minute.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import curl_tpu_torch as ct  # noqa: E402
from chip_smoke import (BENCH_CONFIG, DP_NOISE, DP_PROTOCOLS, SEED,  # noqa: E402
                        dp_noise_scale, dp_protocol_reference, dp_reference_grads, dp_step,
                        dp_targets, lenet_batch, onnx_op_types, rel_l2, rel_l2_by_key,
                        resnet_readings, torch_logits, torch_lenet, torch_resnet18)
from curl_tpu_torch.config import cfg  # noqa: E402
from curl_tpu_torch.utils.torch_onnx_export import export_onnx_bytes  # noqa: E402


def resnet(args):
    model, x = torch_resnet18("cpu", size=args.size)
    ref = torch_logits(model, x, "cpu")
    xt = torch.as_tensor(x, dtype=torch.float64)
    routes = [("from_pytorch", lambda: ct.nn.from_pytorch(model))]
    for folding in (True, False):
        def build(folding=folding):
            data = export_onnx_bytes(model, xt, do_constant_folding=folding)
            print(json.dumps(dict(route=f"export folding={folding}", ops=onnx_op_types(data),
                                  bytes=len(data))), flush=True)
            return ct.nn.from_onnx(data)
        routes.append((f"from_onnx folding={folding}", build))
    for route, build in routes:
        t0 = time.time()
        graph = build()
        plain = rel_l2(np.asarray(graph(x).get_plain_text()), ref)
        graph.encrypt(src=0)
        with cfg.temp_override(BENCH_CONFIG):
            ct.reset_communication_stats()
            logits = graph(ct.cryptensor(x)).get_plain_text()
            stats = ct.get_communication_stats()
        err, agree = resnet_readings(logits, ref)
        print(json.dumps(dict(
            route=route, size=args.size, seed=args.seed, rounds=stats["rounds"],
            bytes=stats["bytes"], rel_l2=err, top1_agrees=bool(agree), plain_rel_l2=plain,
            modules=len(list(graph.named_modules())), seconds=round(time.time() - t0, 1))),
            flush=True)


def dp(args):
    x, _ = lenet_batch()
    y = dp_targets()
    ref = dp_reference_grads(x, y, "cpu")
    for protocol in DP_PROTOCOLS:
        t0 = time.time()
        model = torch_lenet("cpu")
        with cfg.temp_override(BENCH_CONFIG):
            ct.reset_communication_stats()
            clean, step = dp_step(ct, model, x, y, protocol)
            stats = ct.get_communication_stats()
            own = dp_protocol_reference(step, x, "cpu")
            noisy, step = dp_step(ct, model, x, y, protocol, noise=DP_NOISE)
        got, want = dp_noise_scale(step, protocol, noisy, clean)
        print(json.dumps(dict(
            protocol=protocol, seed=args.seed, rounds=stats["rounds"], bytes=stats["bytes"],
            grad_rel_l2=rel_l2_by_key(clean, ref), protocol_rel_l2=rel_l2_by_key(clean, own),
            noise=DP_NOISE, noise_std=got,
            noise_std_expected=want, seconds=round(time.time() - t0, 1))), flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("what", choices=("resnet", "dp"))
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--seed", type=int, default=SEED, help="the session seed")
    args = parser.parse_args()
    ct.init(world_size=2, seed=args.seed, device="cpu")
    resnet(args) if args.what == "resnet" else dp(args)


if __name__ == "__main__":
    main()
