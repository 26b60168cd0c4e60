"""Router checkpoints: the reference's artifacts and the native format.

Counterpart of :mod:`ragroute_tpu.router.torch_import` for the torch module.

* :func:`load_torch_router` reads the reference's ``CorpusRoutingNN`` state
  dict (``best_model.pth`` / ``router_best_model.pt``, ``router.py:106-119``)
  into :class:`CorpusRouter`. Both are torch ``[out, in]`` layouts with the
  same keys (the reference's dropout layers hold no parameters), so the
  tensors go in as they are.
* :func:`load_sklearn_scaler` reads a pickled sklearn ``StandardScaler``
  (``router.py:121-130``) as ``(mean, scale)`` WITHOUT sklearn: a
  restricted unpickler maps the scaler's class to a stub that keeps
  ``mean_`` / ``scale_``, admits numpy's array globals, and refuses every
  other global by name. :func:`dump_preprocessed_data` writes the
  reference's scaler file in sklearn's own pickle layout, which real
  sklearn unpickles into a ``StandardScaler``.
* :func:`save_router_npz` / :func:`load_router_npz`: the native
  ``router.npz``, the JAX package's format byte for byte (a params tree
  ``{layer: {field: array}}`` with ``[in, out]`` weights and LayerNorm
  ``scale`` / ``bias``, plus the threshold and scaler), so either package
  reads the other's. :func:`params_from_jax` / :func:`params_to_jax` carry
  that tree to and from :class:`CorpusRouter`'s ``state_dict``.
"""

from __future__ import annotations

import codecs
import importlib
import os
import pickle
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ragroute_tpu_torch.router.mlp import CorpusRouter

# (layer, field) of the params tree -> (state_dict key, transpose)
_KEY_MAP = {
    ("fc1", "w"): ("fc1.weight", True), ("fc1", "b"): ("fc1.bias", False),
    ("ln1", "scale"): ("ln1.weight", False), ("ln1", "bias"): ("ln1.bias", False),
    ("fc2", "w"): ("fc2.weight", True), ("fc2", "b"): ("fc2.bias", False),
    ("ln2", "scale"): ("ln2.weight", False), ("ln2", "bias"): ("ln2.bias", False),
    ("fc3", "w"): ("fc3.weight", True), ("fc3", "b"): ("fc3.bias", False),
}

Params = Dict[str, Dict[str, np.ndarray]]
Scaler = Tuple[np.ndarray, np.ndarray]


# ---------------------------------------------------------------------------
# The reference's torch checkpoint
# ---------------------------------------------------------------------------

def router_from_state_dict(state: Mapping[str, torch.Tensor]) -> CorpusRouter:
    """A :class:`CorpusRouter` (CPU, eval) holding a reference
    ``CorpusRoutingNN`` state dict; a missing key raises naming it."""
    for key, _ in _KEY_MAP.values():
        if key not in state:
            raise KeyError(
                f"torch checkpoint missing {key!r}; got {list(state)}")
    model = CorpusRouter(int(state["fc1.weight"].shape[1]))
    model.load_state_dict({key: torch.as_tensor(state[key]).float()
                           for key, _ in _KEY_MAP.values()})
    return model.eval()


def load_torch_router(path: str) -> CorpusRouter:
    """Load a reference torch checkpoint (``router.py:117-118``)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return router_from_state_dict(state)


# ---------------------------------------------------------------------------
# sklearn scalers, without sklearn
# ---------------------------------------------------------------------------

_SCALER_GLOBALS = {("sklearn.preprocessing._data", "StandardScaler"),
                   ("sklearn.preprocessing.data", "StandardScaler")}
# numpy's array and scalar reconstructors (numpy 1's and 2's paths)
_DATA_GLOBALS = {
    **{(pkg + ".multiarray", name): "multiarray"
       for pkg in ("numpy.core", "numpy._core")
       for name in ("_reconstruct", "scalar")},
    **{(pkg + ".numeric", "_frombuffer"): "numeric"
       for pkg in ("numpy.core", "numpy._core")},
    ("numpy", "dtype"): None, ("numpy", "ndarray"): None,
    # protocol 2 spells an array's bytes as encode(str, "latin1")
    ("_codecs", "encode"): "codecs",
}


class _ScalerState:
    """Stands in for sklearn's ``StandardScaler`` while unpickling: keeps
    what ``__setstate__`` is given (``mean_``, ``scale_``, ...)."""

    def __setstate__(self, state):
        self.__dict__.update(state)


def _data_global(module: str, name: str):
    sub = _DATA_GLOBALS[(module, name)]
    if sub is None:
        return getattr(np, name)
    if sub == "codecs":
        return codecs.encode
    core = "numpy._core" if hasattr(np, "_core") else "numpy.core"
    return getattr(importlib.import_module(f"{core}.{sub}"), name)


class _ScalerUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _SCALER_GLOBALS:
            return _ScalerState
        if (module, name) in _DATA_GLOBALS:
            return _data_global(module, name)
        raise pickle.UnpicklingError(
            f"global {module}.{name} is not allowed in a scaler pickle "
            f"(only sklearn's StandardScaler and numpy's arrays are read)")


def load_sklearn_scaler(path: str) -> Scaler:
    """Load a pickled sklearn StandardScaler as ``(mean, scale)`` f32.

    Handles both layouts the reference uses: a bare scaler pickle
    (wikipedia, ``router.py:128-130``) and the 5-tuple
    ``preprocessed_data.pkl`` whose 4th element is the scaler (medrag,
    ``router.py:122-125``). A scaler fitted without centring or scaling
    (``mean_`` / ``scale_`` None) reads as zeros / ones."""
    with open(path, "rb") as f:
        obj = _ScalerUnpickler(f).load()
    if isinstance(obj, tuple) and len(obj) == 5:
        obj = obj[3]
    if not isinstance(obj, _ScalerState):
        raise ValueError(f"{path}: holds {type(obj).__name__}, not a "
                         f"StandardScaler")
    mean, scale = obj.__dict__.get("mean_"), obj.__dict__.get("scale_")
    if mean is None and scale is None:
        raise ValueError(f"{path}: the scaler holds neither mean_ nor scale_")
    d = len(mean if mean is not None else scale)
    mean = np.zeros(d) if mean is None else mean
    scale = np.ones(d) if scale is None else scale
    return np.asarray(mean, np.float32), np.asarray(scale, np.float32)


# the version a written scaler names (sklearn warns, and loads, on another)
SKLEARN_VERSION = "1.5.2"


def _chunk(obj) -> bytes:
    """``obj``'s protocol-3 opcodes (no frames) without header and STOP."""
    body = pickle.dumps(obj, protocol=3)
    return body[2:-1]


def dump_preprocessed_data(items: Sequence, mean, scale) -> bytes:
    """The reference's ``preprocessed_data.pkl``, made without sklearn: a
    5-tuple whose element 3 is a fitted sklearn ``StandardScaler`` with this
    ``mean_`` / ``scale_`` (``var_ = scale**2``) in sklearn's own pickle
    layout; ``items`` are the other four (arrays, lists or None)."""
    if len(items) != 4:
        raise ValueError("preprocessed_data holds four items beside the "
                         "scaler")
    mean = np.asarray(mean, np.float64)
    scale = np.asarray(scale, np.float64)
    state = {"with_mean": True, "with_std": True, "copy": True,
             "n_features_in_": int(mean.shape[0]),
             "n_samples_seen_": np.int64(1),
             "mean_": mean, "var_": scale * scale, "scale_": scale,
             "_sklearn_version": SKLEARN_VERSION}
    # GLOBAL class, EMPTY_TUPLE, NEWOBJ, state, BUILD: what pickle writes
    # for a fitted sklearn estimator
    scaler = (b"csklearn.preprocessing._data\nStandardScaler\n)\x81"
              + _chunk(state) + b"b")
    # each chunk numbers its memo from 0 and reads back only what it wrote
    parts = [_chunk(x) for x in items[:3]] + [scaler, _chunk(items[3])]
    return b"\x80\x03(" + b"".join(parts) + b"t."


# ---------------------------------------------------------------------------
# Native checkpoint format (.npz)
# ---------------------------------------------------------------------------

def params_from_jax(params) -> Dict[str, torch.Tensor]:
    """``state_dict`` for :class:`CorpusRouter` from a JAX-layout params
    tree (numpy or jax arrays, ``[in, out]`` weights)."""
    state = {}
    for (layer, field), (key, transpose) in _KEY_MAP.items():
        if layer not in params or field not in params[layer]:
            raise KeyError(f"router params missing {layer}.{field}")
        arr = np.asarray(params[layer][field], dtype=np.float32)
        state[key] = torch.tensor(arr.T if transpose else arr)
    return state


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Params:
    """The JAX-layout params tree (numpy f32, ``[in, out]`` weights) of a
    :class:`CorpusRouter` ``state_dict``."""
    params: Params = {}
    for (layer, field), (key, transpose) in _KEY_MAP.items():
        if key not in state_dict:
            raise KeyError(f"router state_dict missing {key!r}")
        arr = state_dict[key].detach().to("cpu", torch.float32).numpy()
        params.setdefault(layer, {})[field] = np.ascontiguousarray(
            arr.T if transpose else arr)
    return params


def save_router_npz(path: str, state_dict: Mapping[str, torch.Tensor], *,
                    threshold: Optional[float] = None,
                    scaler: Optional[Scaler] = None) -> None:
    """Write a :class:`CorpusRouter` ``state_dict`` (and the decision
    threshold and feature scaler) as ``router.npz``."""
    flat = {f"{layer}.{field}": arr
            for layer, fields in params_to_jax(state_dict).items()
            for field, arr in fields.items()}
    if threshold is not None:
        flat["__threshold__"] = np.float32(threshold)
    if scaler is not None:
        flat["__scaler_mean__"] = np.asarray(scaler[0], np.float32)
        flat["__scaler_scale__"] = np.asarray(scaler[1], np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_router_npz(path: str) -> Tuple[Params, Optional[float],
                                        Optional[Scaler]]:
    """Returns ``(params, threshold_or_None, scaler_or_None)``; the params
    tree goes into a router through :func:`params_from_jax`."""
    data = np.load(path)
    params: Params = {}
    threshold = None
    scaler_mean = scaler_scale = None
    for key in data.files:
        if key == "__threshold__":
            threshold = float(data[key])
        elif key == "__scaler_mean__":
            scaler_mean = data[key]
        elif key == "__scaler_scale__":
            scaler_scale = data[key]
        else:
            layer, field = key.split(".")
            params.setdefault(layer, {})[field] = np.asarray(data[key])
    scaler = None
    if scaler_mean is not None and scaler_scale is not None:
        scaler = (scaler_mean, scaler_scale)
    return params, threshold, scaler


def load_router(path: str) -> Tuple[CorpusRouter, Optional[float],
                                    Optional[Scaler]]:
    """``router.npz`` as ``(CorpusRouter on the CPU, threshold, scaler)``."""
    params, threshold, scaler = load_router_npz(path)
    model = CorpusRouter(int(np.asarray(params["fc1"]["w"]).shape[0]))
    model.load_state_dict(params_from_jax(params))
    return model.eval(), threshold, scaler
