"""Objects with a valid motion a frame on the KITTI-width scene, the JAX
package's frontend beside the port's, on the CPU and on the same frames.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/object_motion_count.py [--frames 20] [--seed 0]

The scene is the bench's (`bench.py:62-95`, the port's
`testing/scenes.py:kitti_scene`): 1280x384, fx 718, 3 moving objects,
N(0, 0.5) px flow noise from numpy `seed`, rendered by the JAX package.
Both frontend-only pipelines (`kitti_config`: 1000 features a frame,
capacities 2048/4096/16) take the same frames.  Prints, per frame, how many
objects each frontend gives a valid motion (`objects.motion_valid`), the
count behind fault F1 (ROADMAP.md).  About 4 minutes.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynosam_tpu.pipeline import DynoPipeline as JPipeline
from dynosam_tpu.testing.render import RenderConfig as JRenderConfig
from dynosam_tpu.testing.render import RenderedScene as JRenderedScene
from dynosam_tpu.utils import config as jcfg
from dynosam_tpu_torch import convert
from dynosam_tpu_torch.frontend.frontend import FrameImages
from dynosam_tpu_torch.pipeline import DynoPipeline


def counts(n_frames: int, seed: int) -> list:
    """Per frame (JAX's count, the port's count) of objects with a valid
    motion."""
    scene = JRenderedScene(JRenderConfig(n_frames=n_frames, h=384, w=1280, fx=718.0, n_objects=3, bg_depth=14.0,
                                         obj_depth=9.0, cam_step=0.10, obj_step=0.18, seed=seed))
    noise = np.random.default_rng(seed)
    frames = [f._replace(flow=f.flow + jnp.asarray(noise.normal(0.0, 0.5, f.flow.shape).astype(np.float32)))
              for f in scene.frames()]
    cfg = jcfg.DynoConfig(
        frontend=jcfg.FrontendConfig(tracker=jcfg.TrackerConfig(max_features_per_frame=1000)),
        capacity=jcfg.CapacityConfig(max_static_tracks=2048, max_dynamic_tracks=4096, max_objects=16),
        pipeline=jcfg.PipelineConfig(use_backend=False),
    )
    jp = JPipeline(scene.cam, cfg)
    tp = DynoPipeline(convert.camera_from_numpy(scene.cam._asdict()), convert.config_from_dict(dataclasses.asdict(cfg)),
                      device="cpu")
    out = []
    for f in frames:
        jk = jp.spin_once(f)
        tk = tp.spin_once(FrameImages(*(torch.as_tensor(np.array(x)) for x in f)))
        out.append((int(np.asarray(jk.objects.motion_valid).sum()), int(tk.objects.motion_valid.sum())))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(4)
    rows = counts(args.frames, args.seed)
    for k, (j, t) in enumerate(rows):
        print(f"frame {k}: objects with a valid motion: JAX {j}, port {t}")
    later = rows[1:]
    print(f"frames 1-{args.frames - 1}: JAX {sum(j for j, _ in later)} valid motions in all, "
          f"port {sum(t for _, t in later)} (seed {args.seed})")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
