"""curl_tpu's readings of the function library's cases, which the port is
held to where running curl_tpu in the test would take too long.

``python3 tests/torch_function_reference.py outputs`` writes
``tests/golden/torch_function_reference.npz``. For every case of
``chip_smoke.FUNCTION_CASES`` that tests/test_torch_functions.py does not
run curl_tpu on eagerly, it holds curl_tpu's decoded output on the test's
(4, 8) input (run eagerly with ``curl_tpu.init(world_size=2, seed=1234)``
under the case's override), and under ``worst:<case>`` its worst |error|
against float64 at those points over 64 draws (the input tiled 64 times
down its first axis, one more eager run in the same session): the test
holds the port's one draw to twice it. Those eager runs take 0.3-15 s
each on a CPU, about 4 minutes in all.

``python3 tests/torch_function_reference.py dense`` prints curl_tpu's max
and mean |error| against float64 of every case that is not a fault of the
reference, on phase 3d's input (``chip_smoke.function_input`` at
``FUNCTION_SHAPE``), run eagerly in blocks of 8 rows in one session seeded
as above (the rows repeat one grid, and each block draws afresh on it),
under the case's override: ``chip_smoke.CURL_TPU_DENSE_ERR``.

Run from the repo's root with ``JAX_PLATFORMS=cpu``.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_function_reference.npz")
DENSE_ROWS = 8
TILES = 64


def decoded(out):
    if isinstance(out, tuple):
        return np.stack([np.asarray(o.get_plain_text()) for o in out])
    return np.asarray(out.get_plain_text())


def curl_tpu_eager(key, x, init=True):
    """curl_tpu's decoded output of a case on x, eagerly, seed 1234 (or the
    session's next draws, ``init=False``)."""
    import curl_tpu
    from chip_smoke import FUNCTION_CASES, function_call

    if init:
        curl_tpu.init(world_size=2, seed=1234)
    with curl_tpu.cfg.temp_override(FUNCTION_CASES[key][1]):
        return decoded(function_call(curl_tpu.cryptensor(x), key))


def golden_keys():
    """The cases the test holds to this file: neither a default-config
    function nor a fault it runs curl_tpu on eagerly."""
    from chip_smoke import FUNCTION_CASES, FUNCTION_FAULTS, FUNCTION_TOLS

    return sorted(k for k in FUNCTION_CASES
                  if k not in FUNCTION_TOLS and k not in FUNCTION_FAULTS)


def write_outputs():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_functions import CASES

    from chip_smoke import function_plain

    out = {}
    for key in golden_keys():
        x = CASES[key][2]
        out[key] = curl_tpu_eager(key, x)
        tiled = np.tile(x, (TILES,) + (1,) * (x.ndim - 1))
        err = np.abs(curl_tpu_eager(key, tiled, init=False) - function_plain(key, tiled))
        out[f"worst:{key}"] = np.float64(err.max())
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {len(out)} cases to {GOLDEN}")


def dense_errors():
    import curl_tpu
    from chip_smoke import (FUNCTION_CASES, FUNCTION_FAULTS, FUNCTION_SHAPE, function_input,
                            function_plain)

    print("CURL_TPU_DENSE_ERR = {")
    for key in FUNCTION_CASES:
        if key in FUNCTION_FAULTS:
            continue
        x = function_input(key, FUNCTION_SHAPE)
        curl_tpu.init(world_size=2, seed=1234)
        errs = []
        for r in range(0, x.shape[0], DENSE_ROWS):
            block = x[r:r + DENSE_ROWS]
            got = curl_tpu_eager(key, block, init=False)
            errs.append(np.abs(got - function_plain(key, block)))
        err = np.concatenate(errs, axis=-len(x.shape))
        print(f'    "{key}": ({float(err.max()):.6g}, {float(err.mean()):.6g}),', flush=True)
    print("}")


if __name__ == "__main__":
    {"outputs": write_outputs, "dense": dense_errors}[sys.argv[1]]()
