"""Run a function on N local gloo ranks, one process each: how the parallel
layer is exercised on a CPU.

    results = run_ranks("module:function", world, kwargs, timeout=240)

starts ``python -m dynosam_tpu_torch.testing.gloo`` N times on a free
localhost port.  Each rank sets one torch thread, joins the gloo group
(`multihost.initialize(..., device="cpu")`), calls
``function(rank, world, **kwargs)`` and saves what it returns with
`torch.save`; `run_ranks` returns the N results in rank order.  A rank
that exceeds `timeout` seconds ends every rank and raises, so a hang
fails instead of stalling; a rank that fails raises with its output.
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile

import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(target: str, world: int, kwargs: dict | None = None, timeout: float = 240,
              pythonpath: list | None = None) -> list:
    """Results of `target` ("module:function") on `world` gloo ranks;
    `pythonpath` entries are prepended to the ranks' `PYTHONPATH`."""
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([*(pythonpath or []), env.get("PYTHONPATH", "")]).strip(os.pathsep)
    env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, "-m", "dynosam_tpu_torch.testing.gloo", target, str(r),
                                   str(world), str(port), outs[r], json.dumps(kwargs or {})],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.wait()
            raise
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {target} failed ({p.returncode}):\n{log[-4000:]}")
        return [torch.load(o, weights_only=False) for o in outs]


def main() -> None:
    target, rank, world, port, out, kwargs = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from ..parallel import multihost

    multihost.initialize(f"localhost:{port}", world, rank, device="cpu")
    try:
        mod, fn = target.split(":")
        result = getattr(importlib.import_module(mod), fn)(rank, world, **json.loads(kwargs))
        torch.save(result, out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
