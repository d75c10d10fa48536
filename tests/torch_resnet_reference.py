"""curl_tpu's readings of the ResNet modules that tests/test_torch_resnet.py
holds the port to, where running curl_tpu in the test would take too long
(its eager BasicBlock, Bottleneck and stem take about 3 minutes on a CPU;
its BatchNorm's public statistics do not trace through compile_parties).

    JAX_PLATFORMS=cpu python3 tests/torch_resnet_reference.py

writes ``tests/golden/torch_resnet_reference.npz``: for each module of
tests/test_torch_resnet.py's ``MODULES`` (built by curl_tpu, 8 channels),
its state dict (curl_tpu's initial weights, BatchNorm statistics and
affine drawn by ``_numpy_state``), and curl_tpu's decoded output, rounds
and bytes of one eager private forward on the test's input, at
``mpc.compare_bits`` 64 (where curl_tpu's max-pool pad is ordered),
``curl_tpu.init(world_size=2, seed=1234)``. Run from the repo's root.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_resnet_reference.npz")
CONFIG = {"mpc.compare_bits": 64}


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import curl_tpu
    from curl_tpu import comm as jcomm
    from curl_tpu import models as jmodels
    from curl_tpu import nn as jnn
    from test_torch_resnet import MODULES, _numpy_state

    out = {}
    curl_tpu.init(world_size=2, seed=1234)
    for i, (name, (build, x)) in enumerate(MODULES.items()):
        module = build(jnn, jmodels)
        sd = _numpy_state(module, seed=i)
        module.encrypt()
        with curl_tpu.no_grad(), curl_tpu.cfg.temp_override(CONFIG):
            jcomm.reset_communication_stats()
            decoded = module(curl_tpu.cryptensor(x)).get_plain_text()
            stats = jcomm.get_communication_stats()
        for k, v in sd.items():
            out[f"{name}/sd/{k}"] = v
        out[f"{name}/output"] = np.asarray(decoded)
        out[f"{name}/counts"] = np.array([stats["rounds"], stats["bytes"]])
        print(name, stats["rounds"], stats["bytes"], flush=True)
    np.savez_compressed(GOLDEN, **out)


if __name__ == "__main__":
    main()
