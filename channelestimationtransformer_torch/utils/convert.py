"""Weight bridge: the JAX package's Informer, Transformer and recurrent
baseline variables -> a port ``state_dict``, and back (:func:`to_flax`).

Input is the flax variable tree as nested dicts of numpy arrays (the caller
converts device arrays with ``np.asarray``, so this module never sees a JAX
type). The port's modules carry the flax names, so each flax leaf maps to
the key of the same path, with these conversions:

- Dense kernels ``[in, out]`` -> ``Linear.weight`` ``[out, in]`` (the
  fused ``qkv`` / ``kv`` projections of ``fuse_qkv`` likewise); an LSQ
  layer's scalar ``step_size`` goes along as it is;
- conv kernels ``[K, C_in, C_out]`` -> ``weight`` ``[C_out, C_in, K]``;
- norm ``scale`` -> ``weight``; BatchNorm ``mean``/``var`` (from
  ``batch_stats``) -> ``running_mean``/``running_var``.

A ProbSparse model (``attn="prob"``) has the parameters of a full one.
The recurrent cells' per-gate kernels and biases are stacked in torch's
gate order (``models/recurrent.py``). Each walk knows its architecture: it
raises on any flax leaf it did not consume and on any leaf it needs that is
missing. :func:`load_flax` and the other ``load_`` functions then load with
``strict=True``, which raises on any torch parameter or buffer left
unfilled.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _join(path: str, name: str) -> str:
    return f"{path}.{name}" if path else name


def _flatten(tree, prefix="", out=None) -> dict:
    out = {} if out is None else out
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            _flatten(sub, _join(prefix, name), out)
        else:
            out[_join(prefix, name)] = sub
    return out


class FlaxBridge:
    """Walks a flax tree module by module, filling ``state_dict``. Each
    method converts the module at ``path`` (``""`` for a tree that holds just
    that module)."""

    def __init__(self, params, batch_stats=None):
        self.params = _flatten(params)
        self.stats = _flatten(batch_stats or {})
        self.used = set()
        self.state_dict = {}

    def _take(self, leaves, path, label):
        if path not in leaves:
            raise KeyError(f"flax {label} lack the leaf {path!r}")
        self.used.add((label, path))
        return torch.from_numpy(np.array(leaves[path], dtype=np.float32))

    def param(self, path):
        return self._take(self.params, path, "params")

    def has(self, path: str) -> bool:
        return any(k.startswith(path + ".") for k in self.params)

    def check_consumed(self):
        left = ([k for k in self.params if ("params", k) not in self.used]
                + [f"batch_stats.{k}" for k in self.stats
                   if ("batch_stats", k) not in self.used])
        if left:
            raise ValueError(f"flax leaves not consumed by the port: {sorted(left)}")

    def _set(self, path, name, value):
        self.state_dict[_join(path, name)] = value

    def dense(self, path):
        self._set(path, "weight", self.param(_join(path, "kernel")).T.contiguous())
        self._set(path, "bias", self.param(_join(path, "bias")))
        step = _join(path, "step_size")
        if step in self.params:  # an LSQ layer (ops/quant/lsq.py:DenseLSQ)
            self._set(path, "step_size", self.param(step))

    def norm(self, path):
        self._set(path, "weight", self.param(_join(path, "scale")))
        self._set(path, "bias", self.param(_join(path, "bias")))

    def conv_weight(self, path):
        kernel = self.param(_join(path, "kernel"))
        self._set(path, "weight", kernel.permute(2, 1, 0).contiguous())

    def embedding(self, path):
        self.conv_weight(_join(path, "token"))

    def attention(self, path):
        """The projections of an ``AttentionLayer``: ``query``, ``key`` and
        ``value``, or with ``fuse_qkv`` one ``qkv`` (self-attention) or a
        ``query`` and one ``kv`` (cross-attention); then ``out``. The kernels
        of a fused projection are ``[d_model, 3d]`` / ``[d_model, 2d]`` with
        Q, K, V side by side, as the port's weight rows are."""
        if self.has(_join(path, "qkv")):
            names = ("qkv",)
        elif self.has(_join(path, "kv")):
            names = ("query", "kv")
        else:
            names = ("query", "key", "value")
        for name in names + ("out",):
            self.dense(_join(path, name))

    def distil(self, path):
        self.conv_weight(path)
        self._set(path, "bias", self.param(_join(path, "bias")))
        bn = _join(path, "norm")
        self.norm(bn)
        self._set(bn, "running_mean", self._take(self.stats, _join(bn, "mean"), "batch_stats"))
        self._set(bn, "running_var", self._take(self.stats, _join(bn, "var"), "batch_stats"))
        self._set(bn, "num_batches_tracked", torch.tensor(0))

    def _ffn_and_norms(self, path, n_norms):
        self.dense(_join(path, "ffn.conv1"))
        self.dense(_join(path, "ffn.conv2"))
        for i in range(1, n_norms + 1):
            self.norm(_join(path, f"norm{i}"))

    def encoder_layer(self, path):
        self.attention(_join(path, "attention"))
        self._ffn_and_norms(path, 2)

    def decoder_layer(self, path):
        self.attention(_join(path, "self_attention"))
        self.attention(_join(path, "cross_attention"))
        self._ffn_and_norms(path, 3)

    def _numbered(self, path, name):
        i = 0
        while self.has(_join(path, f"{name}_{i}")):
            yield _join(path, f"{name}_{i}")
            i += 1

    def encoder(self, path):
        for layer in self._numbered(path, "layer"):
            self.encoder_layer(layer)
        for conv in self._numbered(path, "distil"):
            self.distil(conv)
        self.norm(_join(path, "norm"))

    def informer(self):
        self.embedding("enc_embedding")
        self.embedding("dec_embedding")
        if self.has("encoder.encoder_0"):
            for enc in self._numbered("encoder", "encoder"):
                self.encoder(enc)
        else:
            self.encoder("encoder")
        for layer in self._numbered("decoder", "layer"):
            self.decoder_layer(layer)
        self.norm("decoder.norm")
        self.dense("projection")


    def pre_norm_block(self, path, cross):
        """A Transformer ``PreNormBlock``."""
        names = ("self_attention", "cross_attention") if cross else ("self_attention",)
        for name in names:
            self.attention(_join(path, name))
        for norm in ("norm_attn", "norm_cross", "norm_ffn") if cross else ("norm_attn",
                                                                           "norm_ffn"):
            self.norm(_join(path, norm))
        self.dense(_join(path, "ffn1"))
        self.dense(_join(path, "ffn2"))

    def transformer(self):
        self.embedding("src_embed")
        self.embedding("tgt_embed")
        for block in self._numbered("", "encoder"):
            self.pre_norm_block(block, cross=False)
        for block in self._numbered("", "decoder"):
            self.pre_norm_block(block, cross=True)
        self.norm("encoder_norm")
        self.norm("decoder_norm")
        self.dense("projection")

    def _gates(self, path, names, leaf):
        """The ``leaf`` of each gate in ``names``, stacked on dim 0 (kernels
        transposed to ``[out, in]`` first)."""
        parts = [self.param(_join(_join(path, n), leaf)) for n in names]
        return torch.cat([p.T for p in parts] if leaf == "kernel" else parts, dim=0)

    def recurrent_cell(self, path):
        """One flax cell (OptimizedLSTMCell, GRUCell or SimpleCell, told
        apart by their kernels' names) in torch's stacked gate layout."""
        if self.has(_join(path, "ii")):
            i_names, h_names = ("ii", "if", "ig", "io"), ("hi", "hf", "hg", "ho")
            biases = {"bias_hh": h_names}
        elif self.has(_join(path, "ir")):
            i_names, h_names = ("ir", "iz", "in"), ("hr", "hz", "hn")
            biases = {"bias_ih": i_names, "bias_hn": ("hn",)}
        else:
            i_names, h_names = ("i",), ("h",)
            biases = {"bias_ih": i_names}
        self._set(path, "weight_ih", self._gates(path, i_names, "kernel").contiguous())
        self._set(path, "weight_hh", self._gates(path, h_names, "kernel").contiguous())
        for name, gates in biases.items():
            self._set(path, name, self._gates(path, gates, "bias"))

    def recurrent(self):
        self.dense("encoder")
        for cell in self._numbered("", "cells"):
            self.recurrent_cell(cell)
        self.dense("decoder")


def from_flax(params, batch_stats=None) -> dict:
    """The port ``state_dict`` of an Informer/InformerStack flax tree.
    Raises on a flax leaf it does not consume or a needed leaf that is missing."""
    bridge = FlaxBridge(params, batch_stats)
    bridge.informer()
    bridge.check_consumed()
    return bridge.state_dict


def load_flax(model: torch.nn.Module, params, batch_stats=None) -> torch.nn.Module:
    """Load :func:`from_flax`'s ``state_dict`` into ``model`` strictly:
    raises on any parameter or buffer it does not fill."""
    model.load_state_dict(from_flax(params, batch_stats), strict=True)
    return model


def _bridged(walk: str, params) -> dict:
    bridge = FlaxBridge(params)
    getattr(bridge, walk)()
    bridge.check_consumed()
    return bridge.state_dict


def from_flax_transformer(params) -> dict:
    """The port ``state_dict`` of a flax ``Transformer`` baseline's params
    (``models/transformer.py``). Raises on a flax leaf it does not consume
    or a needed leaf that is missing."""
    return _bridged("transformer", params)


def load_flax_transformer(model: torch.nn.Module, params) -> torch.nn.Module:
    """Load :func:`from_flax_transformer`'s ``state_dict`` strictly."""
    model.load_state_dict(from_flax_transformer(params), strict=True)
    return model


def from_flax_recurrent(params) -> dict:
    """The port ``state_dict`` of a flax ``RecurrentPredictor``'s params
    (``models/recurrent.py``), each cell's gates stacked in torch's order.
    Raises on a flax leaf it does not consume or a needed leaf that is
    missing."""
    return _bridged("recurrent", params)


def load_flax_recurrent(model: torch.nn.Module, params) -> torch.nn.Module:
    """Load :func:`from_flax_recurrent`'s ``state_dict`` strictly."""
    model.load_state_dict(from_flax_recurrent(params), strict=True)
    return model


# The recurrent cells' flax gate names, in torch's stacked order (FlaxBridge.recurrent_cell).
_GATES = {"lstm": (("ii", "if", "ig", "io"), ("hi", "hf", "hg", "ho")),
          "gru": (("ir", "iz", "in"), ("hr", "hz", "hn")),
          "rnn": (("i",), ("h",))}


def _put(tree: dict, path: str, value) -> None:
    *parents, leaf = path.split(".")
    for name in parents:
        tree = tree.setdefault(name, {})
    tree[leaf] = value


def _cell_to_flax(params: dict, path: str, cell: dict) -> None:
    """One recurrent cell's torch tensors (``weight_ih``, ...) -> its flax
    gates, the inverse of :meth:`FlaxBridge.recurrent_cell`."""
    kind = "lstm" if "bias_hh" in cell else "gru" if "bias_hn" in cell else "rnn"
    i_names, h_names = _GATES[kind]
    for names, weight in ((i_names, "weight_ih"), (h_names, "weight_hh")):
        for name, w in zip(names, np.split(cell[weight], len(names))):
            _put(params, _join(path, f"{name}.kernel"), np.ascontiguousarray(w.T))
    biases = {"lstm": {"bias_hh": h_names}, "gru": {"bias_ih": i_names, "bias_hn": ("hn",)},
              "rnn": {"bias_ih": i_names}}[kind]
    for bias, names in biases.items():
        for name, b in zip(names, np.split(cell[bias], len(names))):
            _put(params, _join(path, f"{name}.bias"), b)


def to_flax(state_dict) -> tuple[dict, dict]:
    """A port ``state_dict`` (Informer, Transformer or recurrent baseline)
    -> flax ``(params, batch_stats)`` as nested dicts of float32 numpy
    arrays, the inverse of :func:`from_flax` and its siblings: Linear
    ``[out, in]`` -> Dense ``kernel`` ``[in, out]``, conv ``[C_out, C_in, K]``
    -> ``kernel`` ``[K, C_in, C_out]``, norm ``weight`` -> ``scale``,
    ``running_mean`` / ``running_var`` -> ``batch_stats`` ``mean`` /
    ``var``; ``num_batches_tracked`` has no flax counterpart and is dropped.
    Raises on a key it does not know."""
    params, stats, cells = {}, {}, {}
    for key, value in state_dict.items():
        path, _, name = key.rpartition(".")
        if name == "num_batches_tracked":
            continue
        arr = value.detach().to("cpu", torch.float32).numpy()
        if name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh", "bias_hn"):
            cells.setdefault(path, {})[name] = arr
        elif name in ("running_mean", "running_var"):
            _put(stats, _join(path, name.removeprefix("running_")), arr)
        elif name == "weight" and arr.ndim in (2, 3):
            kernel = arr.T if arr.ndim == 2 else arr.transpose(2, 1, 0)
            _put(params, _join(path, "kernel"), np.ascontiguousarray(kernel))
        elif name == "weight" and arr.ndim == 1:
            _put(params, _join(path, "scale"), arr)
        elif name in ("bias", "step_size"):
            _put(params, key, arr)
        else:
            raise KeyError(f"no flax counterpart for the port's {key!r}")
    for path, cell in cells.items():
        _cell_to_flax(params, path, cell)
    return params, stats
