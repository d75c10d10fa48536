"""CPU readings behind chip_smoke.py's phase 12 bounds and round count:
examples/mpc_cifar.py's LeNet training path at full width (3 x 32 x 32,
10 classes, batch 64, weights and data from chip_smoke's numpy seeds)
under bench.py's kernel configuration, 2 parties: the planted fault
(conv2's input detached, so no gradient reaches conv1), 3 eager SGD steps,
then the step through compile_parties and 3 replays fed back, each against
the float64 SGD trajectory of the same weights and batch
(``chip_smoke.train_readings``).

    python3 scripts/torch_train_bound.py [--seed 11] [--batch 64]

Prints one JSON line: the rounds and bytes of one step (forward, backward
and SGD) eager and captured, the worst relative L2 error of step 1's
parameter gradients and of the parameters after the eager and the captured
steps, the losses beside float64's and the worst loss error, and the
planted fault's gradient error. These are CPU runs, never device numbers.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import curl_tpu_torch as ct  # noqa: E402
from chip_smoke import BENCH_CONFIG, LENET_BATCH, SEED, train_readings  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=SEED, help="the session seed")
    parser.add_argument("--batch", type=int, default=LENET_BATCH)
    args = parser.parse_args()
    t0 = time.time()
    ct.init(world_size=2, seed=args.seed, device="cpu")
    r = train_readings(ct, "cpu", batch=args.batch, config=BENCH_CONFIG)
    print(json.dumps(dict(
        seed=args.seed, batch=args.batch, rounds=r["stats"]["rounds"], bytes=r["stats"]["bytes"],
        captured_rounds=r["capture_stats"]["rounds"], captured_bytes=r["capture_stats"]["bytes"],
        grad_rel_l2=r["grads"], param_rel_l2=r["params"],
        captured_param_rel_l2=r["captured_params"], losses=r["losses"],
        captured_losses=r["captured_losses"], losses_float64=r["losses64"],
        loss_err=r["loss_err"], fault_grad_rel_l2=r["fault"],
        seconds=round(time.time() - t0, 1))))


if __name__ == "__main__":
    main()
