"""Phase timing of K5 (`csrc/refine.cu`) and K6's polish (`csrc/ransac.cu`)
on the card, or with `--window` of K8's segment pass and K9's trial pass
(`csrc/window.cu`), from cycle stamps in an instrumented copy of the
sources.

    python3 dynosam_tpu_torch/testing/kernel_phases.py [--root TREE] [--label NAME] [--out FILE] [--window]

Run by path from a checkout on a machine with a CUDA card and `nvcc`.
`--root` is the tree whose sources and package are measured (default: the
checkout holding this file), so one copy of the script times an older tree
unpacked beside it (`git archive <commit> | tar -x -C build/parent`).

The committed kernels carry no stamps.  This script copies `csrc/` into
`build/probe/<label>/`, turns each `// phase: NAME` comment of `refine.cu`
and `ransac.cu` into a stamp (thread 0 of every block adds the `clock64`
cycles since the previous stamp to the phase that ended and counts the
phase that begins; `begin` and `end` open and close the record), builds
those two sources into a library of their own with the flags of the
tree's `kernels/build.py`, and launches it through the tree's own
wrappers on the calls that eager steps of the main path make
(`chip_smoke.record_solver_calls`: 1280x384 frames, `kitti_config`), the
last steady frame's FlowPose and MotionOnly refinements and ego and
object RANSACs.  Sources written before the markers existed are marked
from `ANCHORS` (lines of the sources of commit 740c31a).  With `--window`,
`window.cu` alone is instrumented and K8 and K9 launch through the tree's
wrappers on the state of a window LM after its head and first build
(`testing/window_check.py:Pieces`), on the first window of the online
pipeline over 12 KITTI-width frames and on the simulator window
(`testing/window_split.py:kitti_window`, `window_check.simulator_window`).

Printed and written as JSON (`--out`): for each call, the slowest block's
cycles and microseconds per phase (cycles over the block's own
`%globaltimer` span) and how often each phase began, beside the
uninstrumented kernels' device time per launch from the profiler (K6's
score and polish kernels apart).  The stamps add a few cycles and a
local-memory access per phase on thread 0; compare phases, not totals,
with the uninstrumented times.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

NPH = 32           # phases a source may have
MAXB = 1024        # blocks a probed launch may have
PROBED = ("refine.cu", "ransac.cu")
WINDOW_PROBED = ("window.cu",)

# (text of a source line, its occurrence, phase, stamp before or after it)
ANCHORS = {
    "refine.cu": [
        ("const int b = blockIdx.x, tid = threadIdx.x;", 0, "begin", "after"),
        ("// ---- head", 0, "head", "before"),
        ("// ---- linearise, eliminate the tracks (pass A)", 0, "pass A", "before"),
        ("dyno::block_sum<NA>(acc, red);", 0, "NA sum", "before"),
        ("// ---- the global step", 0, "global step", "before"),
        ("// ---- back-substitute the tracks", 0, "pass B", "before"),
        ("dyno::block_sum<K::NF>(loss, red);", 1, "NF sum", "before"),
        ("float new_err = total_error<K>(loss);", 0, "accept", "before"),
        ("// ---- tail: new outliers", 0, "tail", "before"),
        ("if (tid == 0) {", 0, "end", "before"),
    ],
    "ransac.cu": [
        ("const int b = blockIdx.x, tid = threadIdx.x;", 0, "begin", "after"),
        ("// the first hypothesis of the most inliers", 0, "argmax", "before"),
        ("SE3 T = hypothesis<REPROJ>(p, b, k_best, &proper);", 0, "best inliers", "before"),
        ("const SE3 Tinv = dyno::se3_inverse(T);", 0, "GN rows", "before"),
        ("dyno::block_sum<27>(acc, red);", 0, "GN sum", "before"),
        ("if (tid == 0) {", 0, "GN solve", "before"),
        ("// final inliers, counts, status and pose", 0, "final", "before"),
        ("if (tid == 0) {", 1, "end", "before"),
    ],
}

PRELUDE = r"""
// ---- phase probe (instrumented copy; not a committed source)
static __device__ unsigned long long dyno_probe_acc[{maxb}][{width}];
static __device__ __forceinline__ unsigned long long dyno_probe_gt() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
#define PROBE_BEGIN                                                                \
  unsigned long long __pa[{nph}] = {{}}, __pn[{nph}] = {{}};                         \
  int __pc = 0;                                                                    \
  const unsigned long long __p0 = clock64(), __g0 = dyno_probe_gt();               \
  unsigned long long __pl = __p0;
#define PROBE_PHASE(k)                                                             \
  if (threadIdx.x == 0) {{                                                          \
    const unsigned long long __t = clock64();                                      \
    __pa[__pc] += __t - __pl;                                                      \
    __pl = __t;                                                                    \
    __pc = (k);                                                                    \
    __pn[(k)] += 1;                                                                \
  }}
#define PROBE_END                                                                  \
  if (threadIdx.x == 0) {{                                                          \
    const unsigned long long __t = clock64();                                      \
    __pa[__pc] += __t - __pl;                                                      \
    for (int __i = 0; __i < {nph}; ++__i) {{                                         \
      dyno_probe_acc[blockIdx.x][__i] = __pa[__i];                                 \
      dyno_probe_acc[blockIdx.x][{nph} + __i] = __pn[__i];                          \
    }}                                                                              \
    dyno_probe_acc[blockIdx.x][2 * {nph}] = __t - __p0;                             \
    dyno_probe_acc[blockIdx.x][2 * {nph} + 1] = dyno_probe_gt() - __g0;             \
  }}
extern "C" int dyno_probe_read_{tag}(void* host) {{
  return (int)cudaMemcpyFromSymbol(host, dyno_probe_acc, sizeof(dyno_probe_acc));
}}
extern "C" int dyno_probe_reset_{tag}() {{
  void* p = nullptr;
  cudaGetSymbolAddress(&p, dyno_probe_acc);
  return (int)cudaMemset(p, 0, sizeof(dyno_probe_acc));
}}
"""


def instrument(name: str, text: str) -> tuple:
    """The source with a stamp at each phase marker, and the phase names by
    id (0: `begin`)."""
    lines = text.split("\n")
    if not any("// phase:" in ln for ln in lines):
        marks = {}
        for anchor, occurrence, phase, where in ANCHORS[name]:
            hits = [i for i, ln in enumerate(lines) if anchor in ln]
            if len(hits) <= occurrence:
                raise RuntimeError(f"{name}: anchor {anchor!r} ({occurrence}) not found")
            marks.setdefault((hits[occurrence], where), []).append(phase)
        out = []
        for i, ln in enumerate(lines):
            out += [f"// phase: {p}" for p in marks.get((i, "before"), [])]
            out.append(ln)
            out += [f"// phase: {p}" for p in marks.get((i, "after"), [])]
        lines = out
    names = ["begin"]
    body = []
    for ln in lines:
        m = re.match(r"\s*// phase: (.+?)\s*$", ln)
        if m is None:
            body.append(ln)
            continue
        phase = m.group(1)
        if phase == "begin":
            body.append("PROBE_BEGIN")
        elif phase == "end":
            body.append("PROBE_END")
        else:
            if phase not in names:
                names.append(phase)
            body.append(f"PROBE_PHASE({names.index(phase)})")
    if len(names) > NPH:
        raise RuntimeError(f"{name}: more than {NPH} phases")
    last_include = max(i for i, ln in enumerate(body) if ln.startswith("#include"))
    prelude = PRELUDE.format(maxb=MAXB, width=2 * NPH + 2, nph=NPH, tag=name.split(".")[0])
    body.insert(last_include + 1, prelude)
    return "\n".join(body), names


def build_probe(root: Path, build, label: str, sources=PROBED) -> tuple:
    """Instrument and build `sources` from `root`'s `csrc/`; returns the
    loaded library and the phase names by source."""
    csrc = root / "dynosam_tpu_torch" / "csrc"
    out_dir = root / "build" / "probe" / label
    if out_dir.exists():
        shutil.rmtree(out_dir)
    shutil.copytree(csrc, out_dir)
    names = {}
    for name in sources:
        text, names[name] = instrument(name, (csrc / name).read_text())
        (out_dir / name).write_text(text)
    nvcc = build._nvcc()
    objs, procs = [], []
    for name in sources:
        obj = out_dir / (name + ".o")
        cmd = [nvcc, *build.FLAGS, *build.SOURCE_FLAGS.get(name, ()), "-Xptxas", "-v", "-c", str(out_dir / name),
               "-o", str(obj)]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs.append(str(obj))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the instrumented {name}:\n{log}")
    digest = hashlib.sha256("".join((out_dir / n).read_text() for n in sources).encode()).hexdigest()[:12]
    lib_path = out_dir / f"libprobe_{digest}.so"
    link = subprocess.run([nvcc, build.ARCH, "-shared", *objs, "-o", str(lib_path)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"link failed:\n{link.stdout}")
    lib = ctypes.CDLL(str(lib_path))
    fns = ("dyno_window_step", "dyno_window_update") if "window.cu" in sources else ("dyno_refine_rounds", "dyno_ransac")
    for fn_name in fns:
        fn = getattr(lib, fn_name)
        fn.argtypes = list(build._SIGNATURES[fn_name])
        fn.restype = ctypes.c_int
    return lib, names


def read_blocks(lib, tag: str) -> list:
    """Every block's record since the last reset that ran: (phase cycles,
    phase counts, total cycles, total ns)."""
    width = 2 * NPH + 2
    host = (ctypes.c_ulonglong * (MAXB * width))()
    code = getattr(lib, f"dyno_probe_read_{tag}")(ctypes.byref(host))
    if code != 0:
        raise RuntimeError(f"probe read failed with error {code}")
    out = []
    for b in range(MAXB):
        rec = host[b * width:(b + 1) * width]
        if rec[2 * NPH] == 0:
            continue
        out.append((list(rec[:NPH]), list(rec[NPH:2 * NPH]), rec[2 * NPH], rec[2 * NPH + 1]))
    return out


def probed(torch, lib, tag: str, names: list, launch) -> dict:
    """One probed launch after a warm-up: the slowest block's phases."""
    launch()
    torch.cuda.synchronize()
    if getattr(lib, f"dyno_probe_reset_{tag}")() != 0:
        raise RuntimeError("probe reset failed")
    launch()
    torch.cuda.synchronize()
    blocks = read_blocks(lib, tag)
    cyc, cnt, total, ns = max(blocks, key=lambda r: r[2])
    per_ns = total / max(ns, 1)
    phases = {names[i]: dict(cycles=cyc[i], us=cyc[i] / per_ns / 1e3, began=cnt[i])
              for i in range(len(names)) if cyc[i] or cnt[i]}
    return dict(blocks=len(blocks), slowest_block_us=ns / 1e3, slowest_block_cycles=total,
                ghz=per_ns, phases=phases)


def window_phases(torch, build, root: Path, args, dev, card) -> int:
    """`--window`: K8's segment pass and K9's trial pass (the update, not
    the head) probed on the KITTI and simulator windows, beside both
    kernels' device time a launch (`window_check.device_ms`)."""
    from dynosam_tpu_torch.backend import schur
    from dynosam_tpu_torch.testing import window_check as wc
    from dynosam_tpu_torch.testing import window_split as ws

    t0 = time.perf_counter()
    lib, names = build_probe(root, build, args.label, WINDOW_PROBED)
    print(f"builds: {time.perf_counter() - t0:.1f} s; phases {json.dumps(names)}", flush=True)
    real = dict(build._Library.functions)
    results = {"label": args.label, "card": card, "K8": {}, "K9": {}}
    for label, make in (("kitti window", lambda: ws.kitti_window(dev)),
                        ("simulator window", lambda: (wc.simulator_window(dev), {}))):
        win_args, kw = make()
        pieces = wc.Pieces(wc.window_lm(win_args, kw))
        a = pieces.lm.args
        sol, info, back = pieces.fixed
        dev_ms = wc.device_ms(pieces)
        for key, fn_name, launch in (("K8", "dyno_window_step", lambda: schur.window_step(a)),
                                     ("K9", "dyno_window_update", lambda: schur.window_update(a, sol, info, back))):
            def run():
                schur.tree_copy_(pieces.lm.s, pieces.s0)
                build._Library.functions[fn_name] = getattr(lib, fn_name)
                try:
                    launch()
                finally:
                    build._Library.functions.update(real)

            rec = probed(torch, lib, "window", names["window.cu"], run)
            rec.update(device_ms=dev_ms["step" if key == "K8" else "update"])
            results[key][label] = rec
            times = ", ".join(f"{p} {v['us']:.2f} us ({v['began']}x)" for p, v in rec["phases"].items())
            print(f"{args.label} {key} {label}: device {rec['device_ms'] * 1e3:.1f} us a launch (both kernels); "
                  f"probed: {rec['blocks']} blocks, slowest {rec['slowest_block_us']:.1f} us at {rec['ghz']:.3f} GHz: "
                  f"{times}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


def main() -> int:
    here = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(here), help="tree whose sources and package are measured")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None, help="JSON file for the results")
    ap.add_argument("--window", action="store_true", help="K8's segment pass and K9's trial pass instead")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from dynosam_tpu_torch.frontend import refine
    from dynosam_tpu_torch.kernels import build
    from dynosam_tpu_torch.kernels import ransac as k6
    from dynosam_tpu_torch.utils.graphs import tree_clone

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"{args.label} ({root}) on {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.load()
    if args.window:
        return window_phases(torch, build, root, args, dev, card)
    lib, names = build_probe(root, build, args.label)
    print(f"builds: {time.perf_counter() - t0:.1f} s; phases {json.dumps(names)}", flush=True)
    calls = cs.record_solver_calls(torch, dev, n_main=6, n_golden=0, n_3d3d=0)
    results = {"label": args.label, "card": card, "K5": {}, "K6": {}}
    real = dict(build._Library.functions)

    def with_probe(fn_name, launch):
        build._Library.functions[fn_name] = getattr(lib, fn_name)
        try:
            return launch()
        finally:
            build._Library.functions.update(real)

    for label, kind, P, R0 in [c for c in calls["K5"] if c[0] != "main path frame 0"][-2:]:
        kname = type(kind).__name__
        run = lambda: refine.run_rounds(kind, P, tree_clone(R0))  # noqa: E731
        dev_ms = cs.device_ms_per_call(torch, run, ("refine_rounds_kernel",), reps=20)
        rec = with_probe("dyno_refine_rounds", lambda: probed(torch, lib, "refine", names["refine.cu"], run))
        rec.update(label=label, shape=list(R0["active"].shape), device_ms=dev_ms)
        results["K5"][kname] = rec
    for label, args6, _ in [c for c in calls["K6"] if c[0] != "main path frame 0"][-2:]:
        kind = "ego" if args6[0].shape[0] == 1 else "objects"
        run = lambda: k6.ransac(*args6)  # noqa: E731
        score = cs.device_ms_per_call(torch, run, ("ransac_score_kernel",), reps=20)
        polish = cs.device_ms_per_call(torch, run, ("ransac_polish_kernel",), reps=20)
        rec = with_probe("dyno_ransac", lambda: probed(torch, lib, "ransac", names["ransac.cu"], run))
        rec.update(label=label, shape=[args6[0].shape[0], args6[3].shape[1], args6[0].shape[1]],
                   score_device_ms=score, polish_device_ms=polish)
        results["K6"][kind] = rec
    for key in ("K5", "K6"):
        for kind, rec in results[key].items():
            times = ", ".join(f"{p} {v['us']:.2f} us ({v['began']}x)" for p, v in rec["phases"].items())
            dev_t = (f"device {rec['device_ms'] * 1e3:.1f} us" if key == "K5" else
                     f"score {rec['score_device_ms'] * 1e3:.1f} us, polish {rec['polish_device_ms'] * 1e3:.1f} us")
            print(f"{args.label} {key} {kind} {rec['shape']} ({rec['label']}): {dev_t} a launch; probed: "
                  f"{rec['blocks']} blocks, slowest {rec['slowest_block_us']:.1f} us at {rec['ghz']:.3f} GHz: "
                  f"{times}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
