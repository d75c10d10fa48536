"""curl_tpu's readings behind tests/test_torch_convert.py and
tests/test_torch_privacy.py (not collected by pytest).

    JAX_PLATFORMS=cpu python3 tests/torch_convert_reference.py [convert] [ops] [dp]

For every converted model of ``test_torch_convert.CONVERT_CASES`` (session
seed 1234): torch's ONNX export of it (the bytes both packages read) and
curl_tpu's decoded private output, rounds and bytes through
``curl_tpu.nn.from_pytorch`` or ``from_onnx``; for every case of
``OP_CASES`` curl_tpu's output, rounds and bytes; for every case of
``test_torch_privacy.DP_CASES`` curl_tpu's DPSplitModel step: each
gradient, dL/dZ, the loss, and the rounds and bytes of the forward with
the loss and of the backward. Writes
``tests/golden/torch_convert_reference.npz``, about 10 minutes on a CPU;
naming parts rewrites only theirs, keeping the file's others. Rerun it
after changing a case.
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, ROOT)
GOLDEN = os.path.join(HERE, "golden", "torch_convert_reference.npz")


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import curl_tpu
    from curl_tpu.nn import onnx_ops
    from test_torch_convert import (CONVERT_CASES, OP_CASES, SESSION_SEED, convert, export,
                                    model_input, onnx_key, private_run, run_op)
    from test_torch_privacy import DP_CASES, run_case

    parts = set(sys.argv[1:]) or {"convert", "ops", "dp"}
    out = {}
    if os.path.exists(GOLDEN) and parts != {"convert", "ops", "dp"}:
        with np.load(GOLDEN) as z:
            owned = {"convert": lambda k: not k.startswith(("op/", "dp/")),
                    "ops": lambda k: k.startswith("op/"), "dp": lambda k: k.startswith("dp/")}
            out = {k: z[k] for k in z.files
                   if not any(owned[p](k) for p in parts)}
    for name, route in CONVERT_CASES if "convert" in parts else ():
        data = None
        if route != "pytorch":
            data = export(name, route == "onnx folded")
            out[onnx_key(name, route)] = np.frombuffer(data, dtype=np.uint8)
        curl_tpu.init(world_size=2, seed=SESSION_SEED)
        decoded, rounds, nbytes = private_run(curl_tpu, convert(curl_tpu.nn, name, route, data),
                                              model_input(name))
        key = f"{name}/{route.replace(' ', '_')}"
        out[f"{key}/output"] = decoded
        out[f"{key}/counts"] = np.array([rounds, nbytes])
        print(key, rounds, nbytes, flush=True)
    for case in OP_CASES if "ops" in parts else ():
        curl_tpu.init(world_size=2, seed=SESSION_SEED)
        decoded, rounds, nbytes = run_op(curl_tpu, onnx_ops, case)
        out[f"op/{case[0]}/output"] = decoded
        out[f"op/{case[0]}/counts"] = np.array([rounds, nbytes])
        print("op", case[0], rounds, nbytes, flush=True)
    for name in DP_CASES if "dp" in parts else ():
        curl_tpu.init(world_size=2, seed=SESSION_SEED)
        res = run_case(curl_tpu, name)
        for k, g in res["grads"].items():
            out[f"dp/{name}/grad/{k}"] = g
        out[f"dp/{name}/dldz"] = res["dldz"]
        out[f"dp/{name}/loss"] = np.array(res["loss"])
        out[f"dp/{name}/counts"] = np.array(res["counts"])
        print("dp", name, res["counts"], flush=True)
    np.savez_compressed(GOLDEN, **out)


if __name__ == "__main__":
    main()
