"""Checkpoint / resume for solver state.

Counterpart of :mod:`lbfgs_ffnn_tpu.checkpoint`. Any solver state (the
weights, the (S, Y, rho) curvature ring with its head and count, the SVRG
anchor, momentum, the chunked drivers' whole ``_State``) round-trips
through one file, so a long run can resume mid-optimisation with its
quasi-Newton memory intact: save it from a chunked driver's ``callback``
and pass the restored state as ``resume_state``.

The format is ``torch.save`` of a plain tree: a NamedTuple is saved as a
dict keyed by its fields, tuples, lists and dicts as themselves, tensors as
CPU tensors and numbers as numbers. It is read back with ``torch.load(...,
weights_only=True)``, so no class needs allow-listing. The JAX package
writes an Orbax directory, which this package cannot read (it imports torch
only): a JAX state crosses over through numpy instead
(:func:`lbfgs_ffnn_torch.objectives.mlp.slbfgs_state_from_numpy`). The npz
weight files of :func:`save_weights_npz` are the same format in both
packages.

A save synchronises the device and copies every tensor to the host first,
so a state read from a chunked driver's callback is consistent (on the card
the driver may already have enqueued the next chunk; the copy is ordered
after it, and the state's own counter says how far it got). The file is
written beside its name and renamed into place, so a kill during a save
leaves the previous checkpoint whole.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Any

import numpy as np
import torch


def _plain(tree: Any) -> Any:
    """``tree`` as it is saved: NamedTuples as dicts by field, tensors as
    compact CPU copies, numpy arrays as tensors, numpy scalars as numbers."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).contiguous()
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, np.generic):
        return tree.item()
    if hasattr(tree, "_fields"):
        return {f: _plain(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_plain(v) for v in tree)
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _devices(tree: Any) -> set:
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return set().union(*(_devices(v) for v in tree)) if tree else set()
    return set()


def save_checkpoint(path: str | Path, state: Any) -> None:
    """Save a tree of tensors (weights, a RingState, a solver's whole
    state) to the file ``path``."""
    path = Path(path).resolve()
    for dev in _devices(state):
        torch.cuda.synchronize(dev)
    tree = _plain(state)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save(tree, tmp)
    os.replace(tmp, path)


def _load(path: Path) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(path: str | Path, template: Any, *, allow_partial: bool = False) -> Any:
    """Restore into the structure of ``template`` (the same tree, any
    values): each tensor goes to its template tensor's device and must have
    its dtype and shape (a bf16 ring comes back bf16).

    Migration shim, JAX's case for case: solver-state NamedTuples may gain
    fields between releases. When the saved tree's structure does not match
    the template (and only then: a missing file or a read error propagates,
    and so does a dtype or shape that disagrees within a matching
    structure), fields missing from the checkpoint are filled with the
    template's values and fields the template lacks are dropped. Filling is
    only safe for plain counters: a filled array field (the L-BFGS carried
    line prefix) would be inconsistent with the restored iterate, so that
    case raises unless ``allow_partial=True``, and the caller then
    recomputes it before resuming (``lbfgs_chunked(..., resume_state=...)``
    recomputes the prefix from the iterate itself). Filled fields are named
    in a warning.
    """
    path = Path(path).resolve()
    saved = _load(path)
    try:
        return _restore_exact(template, saved, "")
    except Exception as e:
        # The structured restore failed. The overlay below is the shim for
        # the one failure class it exists for, a structure mismatch; any
        # other error propagates untouched.
        if not _is_structure_mismatch(e):
            raise
        try:
            filled: list[str] = []
            out = _fill_from_template(template, saved, "", filled)
            extras = _has_extras(template, saved)
        except Exception as shim_err:
            # The overlay failed too (a leaf that disagrees, a tree too alien
            # for the walk): the structured error is the diagnosable one.
            raise e from shim_err
        if not filled and not extras:
            # The saved structure agrees with the template exactly, so the
            # failure was not a structure mismatch: propagate it.
            raise
        if filled:
            non_scalar = [p for p, is_scalar in filled_kinds(template, filled) if not is_scalar]
            msg = (f"checkpoint at {path} is missing fields filled from the template: "
                   f"{sorted(filled)}")
            if non_scalar and not allow_partial:
                raise ValueError(
                    msg + f". Non-scalar fields {non_scalar} cannot be template-filled safely "
                    "(a stale value would corrupt the resumed run): recompute them from the "
                    "restored state (e.g. prefix = problem.line_prefix.init(state.x, aux)) or "
                    "pass allow_partial=True after doing so.")
            warnings.warn(msg, stacklevel=2)
        return out


def _is_structure_mismatch(e: Exception) -> bool:
    return isinstance(e, (ValueError, TypeError, KeyError))


def _leaf(template: Any, saved: Any, path: str) -> Any:
    """A saved leaf in the template leaf's kind: a tensor of the same dtype
    and shape on the template's device, a numpy array, or a number."""
    where = path or "/"
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"{where}: the checkpoint holds a {type(saved).__name__} where the "
                             "template has a tensor")
        if saved.dtype != template.dtype or saved.shape != template.shape:
            raise ValueError(f"{where}: the checkpoint holds {saved.dtype} "
                             f"{tuple(saved.shape)} where the template has {template.dtype} "
                             f"{tuple(template.shape)}")
        return saved.to(template.device)
    if isinstance(template, np.ndarray):
        arr = saved.numpy() if isinstance(saved, torch.Tensor) else np.asarray(saved)
        if arr.dtype != template.dtype or arr.shape != template.shape:
            raise ValueError(f"{where}: the checkpoint holds {arr.dtype} {arr.shape} where the "
                             f"template has {template.dtype} {template.shape}")
        return arr
    if isinstance(saved, torch.Tensor) and saved.dim() == 0:
        return saved.item()
    return saved


def _restore_exact(template: Any, saved: Any, path: str) -> Any:
    """``saved`` read into ``template``'s structure, which it must match
    exactly: the same fields, keys and lengths."""
    if hasattr(template, "_fields") or isinstance(template, dict):
        keys = template._fields if hasattr(template, "_fields") else tuple(template)
        if not isinstance(saved, dict):
            raise ValueError(f"{path or '/'}: the checkpoint holds a {type(saved).__name__}")
        missing = [k for k in keys if k not in saved]
        extra = [k for k in saved if k not in keys]
        if missing or extra:
            raise ValueError(f"{path or '/'}: fields missing from the checkpoint {missing}, "
                             f"fields not in the template {extra}")
        vals = {k: _restore_exact(template[k] if isinstance(template, dict)
                                  else getattr(template, k), saved[k], f"{path}/{k}")
                for k in keys}
        return type(template)(**vals) if hasattr(template, "_fields") else vals
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(template):
            raise ValueError(f"{path or '/'}: the checkpoint holds a {type(saved).__name__} "
                             f"where the template has {len(template)} elements")
        return type(template)(_restore_exact(t, s, f"{path}/{i}")
                              for i, (t, s) in enumerate(zip(template, saved)))
    return _leaf(template, saved, path)


def _has_extras(template: Any, restored: Any) -> bool:
    """True if the saved tree holds keys, fields or elements the template
    does not: the downgrade half of a structure mismatch (the upgrade half
    is what :func:`_fill_from_template` records as filled)."""
    if hasattr(template, "_fields"):
        if not isinstance(restored, dict):
            return True
        fields = set(template._fields)
        return any(k not in fields for k in restored) or any(
            _has_extras(getattr(template, f), restored[f])
            for f in template._fields if f in restored)
    if isinstance(template, dict):
        if not isinstance(restored, dict):
            return True
        return any(k not in template for k in restored) or any(
            _has_extras(v, restored[k]) for k, v in template.items() if k in restored)
    if isinstance(template, (list, tuple)):
        if isinstance(restored, dict):
            # a sequence saved as a dict keyed "0", "1", ... (JAX's Orbax
            # form); any other key means the node is no sequence
            if not all(isinstance(k, str) and k.isdigit() for k in restored):
                return True
            seq = [restored[k] for k in sorted(restored, key=int)]
        elif isinstance(restored, (list, tuple)):
            seq = list(restored)
        else:
            return True
        if len(seq) > len(template):
            return True
        return any(_has_extras(t, r) for t, r in zip(template, seq))
    return False


def filled_kinds(template: Any, paths: list[str]) -> list[tuple[str, bool]]:
    """Classify each filled path as benign to fill or not: plain scalars
    (counters) and EMPTY containers (the L-BFGS ``prefix=()`` placeholder
    of a problem without a line prefix) are benign; anything holding array
    data is not."""
    out = []
    for p in paths:
        node = template
        ok = True
        for part in p.split("/"):
            if not part:
                continue
            if hasattr(node, "_fields") and part in node._fields:
                node = getattr(node, part)
            elif isinstance(node, dict) and part in node:
                node = node[part]
            elif isinstance(node, (list, tuple)) and part.isdigit():
                node = node[int(part)]
            else:
                ok = False
                break
        if not ok:
            benign = False
        elif isinstance(node, (list, tuple, dict)):
            benign = len(node) == 0
        else:
            try:
                benign = np.ndim(node) == 0
            except Exception:  # an opaque object: play safe
                benign = False
        out.append((p, benign))
    return out


def _fill_from_template(template: Any, restored: Any, path: str, filled: list[str]) -> Any:
    """Overlay ``restored`` (the saved tree) onto ``template``, keeping the
    template's values for missing fields and recording their paths in
    ``filled``."""
    if hasattr(template, "_fields"):  # NamedTuple
        vals = {}
        for fname in template._fields:
            tv = getattr(template, fname)
            sub = f"{path}/{fname}"
            if isinstance(restored, dict) and fname in restored:
                vals[fname] = _fill_from_template(tv, restored[fname], sub, filled)
            else:
                vals[fname] = tv
                filled.append(sub)
        return type(template)(**vals)
    if isinstance(template, dict):
        out = {}
        for k, v in template.items():
            sub = f"{path}/{k}"
            if isinstance(restored, dict) and k in restored:
                out[k] = _fill_from_template(v, restored[k], sub, filled)
            else:
                out[k] = v
                filled.append(sub)
        return out
    if isinstance(template, (list, tuple)):
        if isinstance(restored, (list, tuple, dict)):
            if isinstance(restored, dict):
                # a sequence as a dict needs exactly the keys "0".."len-1";
                # anything else is not this sequence: the template's stays
                # (recorded in ``filled``, so an unsafe fill raises)
                seq = ([restored[str(i)] for i in range(len(template))]
                       if all(str(i) in restored for i in range(len(template))) else None)
            else:
                seq = list(restored)
            if seq is not None and len(seq) == len(template):
                return type(template)(_fill_from_template(t, r, f"{path}/{i}", filled)
                                      for i, (t, r) in enumerate(zip(template, seq)))
        filled.append(path)
        return template
    if restored is None:
        filled.append(path)
        return template
    return _leaf(template, restored, path)


def _numpy(weights) -> np.ndarray:
    if isinstance(weights, torch.Tensor):
        return weights.detach().cpu().numpy()
    return np.asarray(weights)


def save_weights_npz(path: str | Path, weights) -> None:
    """A bare flat weight vector as ``.npz`` (key ``weights``): the JAX
    package's format, read by either package."""
    np.savez(str(path), weights=_numpy(weights))


def load_weights_npz(path: str | Path) -> np.ndarray:
    return np.load(str(path))["weights"]
