"""CPU readings behind chip_smoke.py's phase 11 bound and round counts: a
ResNet (chip_smoke.RESNETS' models, full width and depth, 1000 classes,
He-normal weights from numpy seed 1234, BatchNorm statistics from the
float64 forward) classifying examples/mpc_imagenet.py's input privately
under bench.py's kernel configuration, 2 parties, at a reduced input size.

    python3 scripts/torch_resnet_bound.py --model resnet18 --size 64

Prints one JSON line: rounds and bytes, the private logits' relative L2
error against the float64 forward of the same weights and input, whether
the top-1 class agrees, and the same with the least-felt block left out
(the planted fault), privately and in plaintext. The rounds do not depend
on the input size; the error is read at a reduced size, where the final
average pools fewer positions. These are CPU runs, never device numbers;
about a minute for resnet18 at 64 x 64 on 4 cores.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import curl_tpu_torch as ct  # noqa: E402
from chip_smoke import (BENCH_CONFIG, SEED, build_resnet, resnet_private,  # noqa: E402
                        resnet_readings)
from curl_tpu_torch.config import cfg  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="resnet18")
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--seed", type=int, default=SEED, help="the session seed")
    args = parser.parse_args()
    t0 = time.time()
    ct.init(world_size=2, seed=args.seed, device="cpu")
    model, _, x, ref, block, plain_fault = build_resnet(args.model, "cpu", size=args.size)
    xe = ct.cryptensor(x)
    with cfg.temp_override(BENCH_CONFIG):
        ct.reset_communication_stats()
        logits = model(xe).get_plain_text()
        stats = ct.get_communication_stats()
        fault = resnet_private(model, xe, skip=block).get_plain_text()
    err, agree = resnet_readings(logits, ref)
    fault_err, fault_agree = resnet_readings(fault, ref)
    print(json.dumps(dict(
        model=args.model, size=args.size, seed=args.seed, rounds=stats["rounds"],
        bytes=stats["bytes"], rel_l2=err, top1_agrees=bool(agree), fault_block=list(block),
        fault_rel_l2=fault_err, fault_top1_agrees=bool(fault_agree),
        plaintext_fault_rel_l2=plain_fault, seconds=round(time.time() - t0, 1))))


if __name__ == "__main__":
    main()
