"""dynosam_tpu_torch — the PyTorch + CUDA port of `dynosam_tpu`.

The JAX package `dynosam_tpu` stays the reference; this package mirrors
its module layout (`dynosam_tpu/ops/klt.py` -> `dynosam_tpu_torch/ops/klt.py`)
and imports neither JAX nor anything of `dynosam_tpu`.  Every Pallas kernel
on the ported path has a hand-written Hopper (sm_90a) CUDA kernel under
`csrc/`, bound through `kernels/` with a plain PyTorch version beside it.

Entry points (`pipeline.DynoPipeline`, `frontend.frontend.frontend_step`,
`testing.render.RenderedScene`) run on the CUDA device unless the caller
passes `device="cpu"`; without a card and without that request they raise.
"""

__all__ = ["__version__"]
__version__ = "0.1.0"
