"""Persist / load frozen INT8 inference artifacts (port of
alignq_tpu/kernels/artifact.py).

One .npz holds the converted qparams tree, keyed by tree path exactly as
the JAX package writes it: dict keys, list indices and NamedTuple field
names (QConvInt8, DenseNet's QConvPre and BNAffine) joined by '/'
(`conv0/kernel_int8`, `layers/0/conv0/scale`, `stages/0/blocks/3/bn/bias`,
`logit/kernel`), plus `__meta__/<name>` entries. Artifacts written by
either package load in the other.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in the JAX package's flattening order (dict keys
    sorted, sequences and NamedTuple fields in order)."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))


def _numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_int8_artifact(path: str, qparams: Any, meta: Dict[str, Any] | None = None):
    """Flatten the qparams tree into an npz keyed by tree path."""
    flat = {key: _numpy(leaf) for key, leaf in _leaves(qparams)}
    for k, v in (meta or {}).items():
        flat[f"__meta__/{k}"] = np.asarray(v)
    np.savez_compressed(path, **flat)


def forward_kwargs_from_meta(meta: Dict[str, Any]) -> Dict[str, Any]:
    """Deploy-graph kwargs recorded at export time (act_bits, act_impl,
    stream): the fast-path options are trained semantics, so the artifact
    records which graph its weights were trained for."""
    out: Dict[str, Any] = {}
    if "act_bits" in meta:
        out["act_bits"] = int(meta["act_bits"])
    if "act_impl" in meta:
        impl = str(np.asarray(meta["act_impl"]))
        if impl not in ("erf", "poly", "bins", "bins_int"):
            raise ValueError(f"unknown act_impl {impl!r} in artifact meta")
        out["act_impl"] = impl
    if "stream" in meta:
        s = str(np.asarray(meta["stream"]))
        if s not in ("int16", "int8"):
            raise ValueError(f"unknown stream {s!r} in artifact meta")
        out["stream"] = s
    return out


def _restore(template, data, prefix: str):
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(template, dict):
        return {k: _restore(v, data, key(k)) for k, v in template.items()}
    if hasattr(template, "_fields"):  # any NamedTuple, by its field names
        return type(template)(*(_restore(v, data, key(f)) for f, v in zip(template._fields, template)))
    if isinstance(template, (list, tuple)):
        return [_restore(v, data, key(i)) for i, v in enumerate(template)]
    arr = data[prefix]
    if torch.is_tensor(template):  # 0-d leaves stay 0-d (DenseNet's conv scales)
        return torch.from_numpy(np.array(arr)).to(template.device)
    return arr.item()  # host scalar leaves (in_scale, m)


def load_int8_artifact(path: str, template: Any) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of `template` (a qparams tree of the same
    model, e.g. convert_* on fresh params), each tensor on its template
    leaf's device. Returns (qparams, meta)."""
    with np.load(path) as data:
        meta = {k.split("/", 1)[1]: data[k] for k in data.files if k.startswith("__meta__/")}
        return _restore(template, data, ""), meta
