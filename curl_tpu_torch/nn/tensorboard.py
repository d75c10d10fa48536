"""Model-graph visualization (counterpart of ``curl_tpu/nn/tensorboard.py``;
the reference's curl/nn/tensorboard.py:70).

``graph_to_dot`` writes a Graphviz DOT description of a model's module
tree, one node a module (a box where it holds parameters), each joined to
its parent. ``SummaryWriter.add_graph`` logs that text to a file; no
tensorboard package is needed.
"""

from __future__ import annotations

import os
import tempfile

import torch


def _holds_parameters(mod) -> bool:
    return bool(getattr(mod, "_params", None) or mod._parameters)


def graph_to_dot(model: torch.nn.Module, name="curl_model") -> str:
    lines = [f"digraph {name} {{", "  rankdir=TB;"]
    for path, mod in model.named_modules():
        label = f"{path or 'root'}\\n{type(mod).__name__}"
        node = (path or "root").replace(".", "_")
        shape = "box" if _holds_parameters(mod) else "ellipse"
        lines.append(f'  {node} [label="{label}", shape={shape}];')
        if "." in path:
            parent = path.rsplit(".", 1)[0].replace(".", "_")
            lines.append(f"  {parent} -> {node};")
        elif path:
            lines.append(f"  root -> {node};")
    lines.append("}")
    return "\n".join(lines)


class SummaryWriter:
    """A minimal writer: ``add_graph`` logs the DOT text to
    ``<log_dir>/<name>.dot`` (by default under the temporary directory)."""

    def __init__(self, log_dir=None):
        self.log_dir = log_dir or os.path.join(tempfile.gettempdir(), "curl_tpu_torch_tb")
        os.makedirs(self.log_dir, exist_ok=True)

    def add_graph(self, model, name="model"):
        path = os.path.join(self.log_dir, f"{name}.dot")
        with open(path, "w") as f:
            f.write(graph_to_dot(model, name))
        return path
