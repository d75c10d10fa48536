"""CPU readings behind chip_smoke.py's phase 9 bound, argmax agreement and
round count: the repo's bert-tiny-qnli checkpoint (128 wide, 2 blocks),
read by the port's ``load_safetensors``, classifying phase 9's 8 rows
(seq 64, numpy seed 0) privately under bench.py's kernel configuration.

    python3 scripts/torch_qnli_bound.py

Prints one JSON line: rounds and bytes, the private logits' relative L2
error against the float64 classifier of the same checkpoint, the rows
whose argmax agrees, and the same with block 1 left out (the planted
fault), privately and in plaintext. The whole model runs at full size;
these are CPU runs, never device numbers. About five minutes on 4 cores.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import curl_tpu_torch as ct  # noqa: E402
from chip_smoke import (BENCH_CONFIG, SEED, qnli_model, qnli_private, rel_l2)  # noqa: E402
from curl_tpu_torch.config import cfg  # noqa: E402
from curl_tpu_torch.models import plain_classifier_forward  # noqa: E402


def main():
    t0 = time.time()
    ct.init(world_size=2, seed=SEED, device="cpu")
    model, sd, ids, types = qnli_model(ROOT)
    model.encrypt(src=0)
    ref = plain_classifier_forward(sd, ids, types, model.cfg).numpy()
    plain_fault = plain_classifier_forward(sd, ids, types, model.cfg, skip=1).numpy()
    ids_e = ct.cryptensor(ids.astype(np.float64), precision=0)
    types_e = ct.cryptensor(types.astype(np.float64), precision=0)
    with cfg.temp_override(BENCH_CONFIG):
        ct.reset_communication_stats()
        logits = model(ids_e, types_e).get_plain_text()
        stats = ct.get_communication_stats()
        fault = qnli_private(model, ids_e, types_e, skip=1).get_plain_text()
    print(json.dumps(dict(
        rounds=stats["rounds"], bytes=stats["bytes"], rel_l2=rel_l2(logits, ref),
        agree=int((logits.argmax(-1) == ref.argmax(-1)).sum()),
        fault_rel_l2=rel_l2(fault, ref), fault_agree=int((fault.argmax(-1) == ref.argmax(-1)).sum()),
        plaintext_fault_rel_l2=rel_l2(plain_fault, ref), logits=np.round(logits, 4).tolist(),
        ref=np.round(ref, 4).tolist(), seconds=round(time.time() - t0, 1))))


if __name__ == "__main__":
    main()
