"""Export a torch.nn.Module to ONNX bytes without the ``onnx`` package
(counterpart of ``curl_tpu/utils/torch_onnx_export.py``).

torch's TorchScript-based exporter serializes the ModelProto itself (C++),
but its last post-processing step (``_add_onnxscript_fn``) imports ``onnx``
only to scan the graph for custom onnxscript functions, and re-serializes
only when it finds any. Standard opset-11 exports (everything the
reference's converter handles, curl/nn/onnx_converter.py:164-199) hold
none, so a stand-in whose ``load_model_from_string`` returns an empty graph
makes that step a no-op that passes the original bytes through unchanged.
Where ``onnx`` is installed, it is used as it is.
"""

from __future__ import annotations

import io
import sys
import types
from contextlib import contextmanager


class _EmptyGraph:
    node = ()


class _PassthroughModel:
    graph = _EmptyGraph()
    functions = []


@contextmanager
def _onnx_standin():
    """Temporarily provide a minimal `onnx` module if none is installed."""
    if "onnx" in sys.modules:
        yield
        return
    mod = types.ModuleType("onnx")
    mod.load_model_from_string = lambda data: _PassthroughModel()
    sys.modules["onnx"] = mod
    try:
        yield
    finally:
        if sys.modules.get("onnx") is mod:
            del sys.modules["onnx"]


def export_onnx_bytes(model, args, **kwargs) -> bytes:
    """torch.onnx.export to an in-memory ONNX protobuf (opset 11, like the
    reference's _export_pytorch_model, onnx_converter.py:139-161)."""
    import torch

    kwargs.setdefault("opset_version", 11)
    kwargs.setdefault("do_constant_folding", False)
    buf = io.BytesIO()
    was_training = getattr(model, "training", False)
    model.eval()
    try:
        with _onnx_standin():
            torch.onnx.export(model, args, buf, dynamo=False, **kwargs)
    finally:
        if was_training:
            model.train()
    return buf.getvalue()
