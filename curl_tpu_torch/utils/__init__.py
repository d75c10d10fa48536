"""Helpers of the converter: the ONNX wire-format reader (``onnx_lite``)
and the ONNX export of a torch model to bytes (``torch_onnx_export``)."""
