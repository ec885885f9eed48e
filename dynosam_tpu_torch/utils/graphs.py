"""CUDA graphs of host-scheduled device work, shared by the direct-Schur
window solve (`backend/schur.py:_WindowLM`) and the frontend step
(`frontend/frontend.py:_FrameGraphs`).

Both keep their device state in tensors allocated once, in a dict, and
split their work into named *variants*: callables that read that state
and copy their results back into it (`tree_copy_`), so that every call
reads and writes the same memory.  `capture` records each variant once as
a CUDA graph, all of them in one memory pool, and every later call
replays it.  The host loops that choose between variants stay in Python
and read the device where they did before; what a replay leaves in the
state is overwritten by the next replay, so whatever outlives it is
cloned out (`tree_clone`).

A capture bakes in every tensor address and every function the variant
ran, so its cache key holds the state's layout (`signature`) and the
module functions the variant reaches (`module_functions`): a function
replaced for a run (as `bench_torch/controls.py` replaces one) captures
anew.  Captures are thread-local (`capture_error_mode="thread_local"`):
another thread of the process, such as a loader's prefetch that rectifies
frames on the card, may allocate and synchronise meanwhile.

The port's kernel wrappers count their launches in Python, which a replay
does not run: `capture` records the launches each variant made while it
was captured, gives the counters back what the warm-ups and the capture
added, and each replay adds its variant's launches, so `kernels.
launch_counts()` reads the same graphed as eager.
"""

from __future__ import annotations

import types
from collections import OrderedDict
from typing import Callable

import torch

from .. import kernels

_COUNTS: dict = {}


def counts(family: str) -> dict:
    """{"captures", "replays"} of one family of graphs in this process: sets
    of variants captured, and graphs replayed."""
    return dict(_COUNTS.setdefault(family, {"captures": 0, "replays": 0}))


def count(family: str, what: str) -> None:
    """Add one to a family's "captures" or "replays"."""
    _COUNTS.setdefault(family, {"captures": 0, "replays": 0})[what] += 1


def tree_copy_(dst, src) -> None:
    """Copy every tensor of `src` into the tensor at the same place of
    `dst` (a dict's keys taken from `src`); other leaves, and tensors that
    are their own destination, are skipped."""
    if isinstance(dst, torch.Tensor):
        if dst is not src:
            dst.copy_(src)
    elif isinstance(dst, dict):
        for k in src:
            tree_copy_(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for a, b in zip(dst, src):
            tree_copy_(a, b)


def tree_clone(tree):
    """A copy of `tree` with every tensor of its tuples and dicts cloned
    (`Tensor.clone`: a dense tensor keeps its strides); a list is kept as
    it is."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [tree_clone(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def tree_buffers(tree):
    """A copy of `tree` with every tensor of its tuples and dicts in memory
    of its own laid out as it is (shape, strides, dtype), so that kernels
    reading the copy read what they read from the original, in the same
    order.  Raises for a tensor that repeats elements (a stride of 0)."""
    if isinstance(tree, torch.Tensor):
        if any(st == 0 and n > 1 for st, n in zip(tree.stride(), tree.shape)):
            raise ValueError(f"a tensor of shape {tuple(tree.shape)} and strides {tree.stride()} repeats elements; "
                             "a buffer cannot hold its layout")
        return torch.empty_strided(tree.shape, tree.stride(), dtype=tree.dtype, device=tree.device).copy_(tree)
    if isinstance(tree, dict):
        return {k: tree_buffers(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [tree_buffers(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def signature(tree):
    """The shape, strides and dtype of every tensor of `tree`, in its
    structure (other leaves read as None).  The strides belong to it
    because a kernel may sum in another order over another layout: a graph
    replays bit for bit what the eager code computes only on inputs laid
    out as at its capture."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.stride(), tree.dtype
    if isinstance(tree, dict):
        return tuple((k, signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(signature(v) for v in tree)
    return None


def module_functions(*modules) -> tuple:
    """Every function defined or imported at the top level of `modules`,
    as it is bound now: the part of a capture's key that changes when one
    of them is replaced."""
    return tuple(v for m in modules for v in vars(m).values()
                 if isinstance(v, (types.FunctionType, types.BuiltinFunctionType)))


def lru(cache: OrderedDict, key, make: Callable, maxsize: int):
    """The entry of `cache` under `key`, made by `make()` on a miss; the
    cache keeps the `maxsize` most recently used."""
    entry = cache.pop(key, None)
    if entry is None:
        entry = make()
        while len(cache) >= maxsize:
            cache.popitem(last=False)
    cache[key] = entry
    return entry


class Graph:
    """One captured variant: `replay()` replays it on the current stream
    and adds the kernel launches it was captured with to the counters."""

    def __init__(self, graph, launches: dict):
        self.graph, self.launches = graph, launches

    def replay(self) -> None:
        self.graph.replay()
        kernels.add_launch_counts(self.launches)


def capture(variants: dict, device, warmups: int = 2) -> dict:
    """Capture every variant of `variants` (name -> callable) as a CUDA
    graph, all in one memory pool, after `warmups` eager rounds of all of
    them on the capture stream (the cuBLAS and cuSOLVER handles and
    workspaces are made there, outside a capture).  Returns name -> `Graph`.
    The state is left as the warm-ups leave it; kernel launch counters are
    as they were before the call."""
    before = kernels.launch_counts()
    stream = torch.cuda.Stream(device=device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for _ in range(warmups):
            for fn in variants.values():
                fn()
    torch.cuda.current_stream(device).wait_stream(stream)
    pool = torch.cuda.graph_pool_handle()
    graphs = {}
    for name, fn in variants.items():
        g = torch.cuda.CUDAGraph()
        start = kernels.launch_counts()
        with torch.cuda.graph(g, pool=pool, stream=stream, capture_error_mode="thread_local"):
            fn()
        end = kernels.launch_counts()
        graphs[name] = Graph(g, {k: end[k] - start[k] for k in end if end[k] != start[k]})
    kernels.set_launch_counts(before)
    return graphs
