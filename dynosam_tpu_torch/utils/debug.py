"""Numerical debugging and determinism tools (port of
`dynosam_tpu/utils/debug.py`).

  * `nan_debug()`: a `TorchDispatchMode` that raises `FloatingPointError`
    at the first operator whose floating output holds a NaN, naming the
    operator (the counterpart of `jax_debug_nans`);
  * `check_finite(tree, name)`: host-side check over nested dicts, lists,
    tuples and NamedTuples of tensors, raising with the leaf's path;
  * `deterministic_replay(fn, *args)`: runs `fn` twice and requires
    bit-identical outputs (or within `atol`), which catches host RNG
    leaking in and float atomics whose order changes between runs.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


class nan_debug(TorchDispatchMode):
    """Check every operator's floating outputs inside the scope; raise
    `FloatingPointError` naming the first operator that produced a NaN.
    Each check reads the device, so this is for debugging, not for
    timed runs."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"NaN in the output of {func} (shape {tuple(t.shape)}, dtype {t.dtype})")
        return out


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for x in out for t in _tensors(x)]
    return []


def _leaves(tree, path: str = ""):
    """(path, leaf) pairs of nested dicts, lists, tuples and NamedTuples,
    paths written as the JAX package's `keystr` writes them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def check_finite(tree, name: str = "tree"):
    """Raise with the offending leaf's path if any floating value is not
    finite."""
    for path, leaf in _leaves(tree):
        arr = _host(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
            n_bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(f"{name}{path}: {n_bad} non-finite values (shape {arr.shape})")
    return True


def deterministic_replay(fn: Callable, *args, atol: float = 0.0):
    """Run `fn(*args)` twice and require identical outputs (floating
    leaves within `atol` when it is not 0).  Returns the first output
    with its leaves on the host as numpy arrays, keyed by leaf path."""
    out1 = {p: _host(x) for p, x in _leaves(fn(*args))}
    out2 = {p: _host(x) for p, x in _leaves(fn(*args))}
    if out1.keys() != out2.keys():
        raise AssertionError(f"the two runs gave different trees: {sorted(out1)} vs {sorted(out2)}")
    for p, a in out1.items():
        b = out2[p]
        if a.dtype.kind in "fc" and atol != 0.0:
            np.testing.assert_allclose(a, b, atol=atol, err_msg=p)
        else:
            np.testing.assert_array_equal(a, b, err_msg=p)
    return out1[""] if list(out1) == [""] else out1
