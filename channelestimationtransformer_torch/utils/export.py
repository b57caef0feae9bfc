"""Weight export, dynamic-range analysis and graph export (JAX counterpart
``utils/export.py``).

Reference: ``Utils/exportWeights.py:55-78`` (dump every state-dict tensor to
JSON for hardware export) and
``PaperFigures/WeigthDynamicRange/dynamicRangeMeasurement.py:17-60``
(min/max/mean-|w| table from those dumps).

The port's weights are written under the JAX package's names and layouts
(``utils/convert.py:to_flax``; names joined by ``/`` as JAX's
``ops/quant/optim.py:flatten_path``, Dense ``[in, out]``, conv ``[K, C_in,
C_out]``, in JAX's sorted tree order), so a dump of the port's model equals
JAX's dump of the same weights.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

from .complexity import plain_twin
from .convert import to_flax


def _flax_params(model) -> dict:
    state = model.state_dict() if isinstance(model, torch.nn.Module) else model
    return to_flax(state)[0]


def _named_leaves(tree: dict, prefix: str = "", out=None) -> Dict[str, np.ndarray]:
    """``{"a/b/kernel": array}`` in JAX's flattening order (sorted keys)."""
    out = {} if out is None else out
    for name in sorted(tree):
        path = f"{prefix}/{name}" if prefix else name
        if isinstance(tree[name], dict):
            _named_leaves(tree[name], path, out)
        else:
            out[path] = tree[name]
    return out


def export_weights_json(model, path: str) -> None:
    """Dump every parameter tensor of ``model`` (a module or a
    ``state_dict``) to JSON (name -> nested list), the reference's HW-export
    interchange format, under JAX's names and layouts (BatchNorm statistics
    are not parameters and are left out, as JAX's ``params`` leave them)."""
    data = {k: v.tolist() for k, v in _named_leaves(_flax_params(model)).items()}
    with open(path, "w") as f:
        json.dump(data, f)


def export_graph(model: torch.nn.Module, *example_inputs, path: str) -> str:
    """Write the ``torch.export`` graph of ``model(*example_inputs)`` as text
    to ``path``, the counterpart of JAX's ``export_hlo`` (the reference's
    torchviz / ONNX artifacts, ``FullPrecision/VizualizeNetwork.py:9``). It
    exports the plain path (:func:`complexity.plain_twin`): the CUDA kernels
    are called through ctypes, which the exporter cannot trace."""
    twin = plain_twin(model)
    with torch.no_grad():
        twin(*example_inputs)  # fills the position tables' cache before tracing
        program = torch.export.export(twin, tuple(example_inputs))
    with open(path, "w") as f:
        f.write(str(program))
    return path


def weight_dynamic_range(model) -> Dict[str, Dict[str, float]]:
    """Per-tensor dynamic range report under JAX's names: min / max /
    mean(|w|) / required integer bits (reference
    ``dynamicRangeMeasurement.py:17-60``), computed in float32 numpy as JAX's."""
    report = {}
    for name, w in _named_leaves(_flax_params(model)).items():
        amax = float(np.max(np.abs(w))) if w.size else 0.0
        report[name] = {
            "min": float(w.min()) if w.size else 0.0,
            "max": float(w.max()) if w.size else 0.0,
            "mean_abs": float(np.mean(np.abs(w))) if w.size else 0.0,
            "int_bits": int(np.ceil(np.log2(amax + 1e-12))) + 1 if amax > 0 else 0,
        }
    return report
