"""CPU readings behind chip_smoke.py's phase 3d: every (function, method)
of ``chip_smoke.FUNCTION_CASES`` at phase 3d's shape (64, 3072), by the
composable route under bench.py's kernel configuration, with phase 3d's
session seed and inputs.

    python3 scripts/torch_functions_bound.py

Prints one JSON line {case: [rounds, max |error|, mean |error|]}, the
errors against float64; these are CPU runs of the protocol's arithmetic,
never device numbers. The rounds are the count phase 3d must equal; the
errors are the port's readings beside curl_tpu's on the same grid
(``chip_smoke.CURL_TPU_DENSE_ERR``, which phase 3d's limits are taken
from): the max is the worst of the 64 draws each of the 3072 grid points
gets. About two minutes on 4 cores.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import curl_tpu_torch as ct  # noqa: E402
from chip_smoke import (BENCH_CONFIG, FUNCTION_CASES, FUNCTION_SHAPE, SEED,  # noqa: E402
                        function_call, function_input, function_plain)
from curl_tpu_torch.config import cfg  # noqa: E402


def main():
    ct.init(world_size=2, seed=SEED, device="cpu")
    out = {}
    for key, (_, over, _) in FUNCTION_CASES.items():
        x = function_input(key, FUNCTION_SHAPE)
        xe = ct.cryptensor(x)
        with cfg.temp_override(dict(BENCH_CONFIG, **over)):
            ct.reset_communication_stats()
            got = function_call(xe, key)
            stats = ct.get_communication_stats()
        dec = (np.stack([g.get_plain_text() for g in got]) if isinstance(got, tuple)
               else got.get_plain_text())
        err = np.abs(dec - function_plain(key, x))
        out[key] = [stats["rounds"], float(f"{err.max():.6g}"), float(f"{err.mean():.6g}")]
        print(f"{key}: {out[key]}", file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
