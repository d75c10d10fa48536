"""curl_tpu's readings of the lazy scopes that tests/test_torch_lazy.py
holds the port to: for each of its ``CASES`` (tests/test_lazy.py's seven
scopes, numpy seed 7, session seed 9), curl_tpu's decoded outputs and the
scope's rounds and bytes under curl_tpu's own ``lazy()``, and the rounds
and bytes of the same ops run eagerly (``lazy()`` in no-op form). Running
them in the test would take minutes on a CPU (tests/test_lazy.py alone runs
past 150 s).

    JAX_PLATFORMS=cpu python3 tests/torch_lazy_reference.py

writes ``tests/golden/torch_lazy_reference.npz``. Run from the repo's root.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_lazy_reference.npz")


def main():
    import curl_tpu
    import test_torch_lazy as T

    out = {}
    for name in T.CASES:
        outs, stats, _ = T.run_case(curl_tpu, name)
        for key, value in outs.items():
            out[f"{name}/{key}"] = np.asarray(value, dtype=np.float64)
        out[f"{name}/counts"] = np.array([stats["rounds"], stats["bytes"]])
        _, eager, _ = T.run_case(T.Eager(curl_tpu), name)
        out[f"{name}/eager_counts"] = np.array([eager["rounds"], eager["bytes"]])
        print(name, "scope", stats["rounds"], stats["bytes"], "eager", eager["rounds"],
              eager["bytes"], flush=True)
    np.savez(GOLDEN, **out)
    print("wrote", GOLDEN)


if __name__ == "__main__":
    main()
