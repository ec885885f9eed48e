"""Evaluation plots + PDF report (port of `dynosam_tpu/eval/plotting.py`).

Analog of the reference's evo/matplotlib report generation
(`dynosam_utils/dynosam_utils/evaluation/core/plotting.py`,
`formatting_utils.py`): trajectory top-down views, per-frame error curves,
per-object motion error plots, all collected into a single `results.pdf`.
`matplotlib` is imported by the functions that draw (Agg backend), so the
package and the tables import without it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory_topdown(ax, est: np.ndarray, gt: Optional[np.ndarray],
                            title: str = "trajectory"):
    ax.plot(est[:, 0, 3], est[:, 2, 3], "b-", label="estimate")
    if gt is not None:
        ax.plot(gt[:, 0, 3], gt[:, 2, 3], "k--", label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.axis("equal")
    ax.legend(fontsize=8)


def plot_per_frame_errors(ax, frames, errors, ylabel, title):
    ax.plot(frames, errors, "r-")
    ax.set_xlabel("frame")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.grid(alpha=0.3)


def make_report(output_dir: str, results: Dict, pdf_name: str = "results.pdf"):
    """Render a PDF report from `evaluate_all` results + the raw logs."""
    from ..utils.logger import read_pose_log

    plt = _pyplot()
    from matplotlib.backends.backend_pdf import PdfPages

    path = os.path.join(output_dir, pdf_name)
    with PdfPages(path) as pdf:
        # summary table page
        fig, ax = plt.subplots(figsize=(8.5, 11))
        ax.axis("off")
        lines = ["Evaluation summary", ""]
        for prefix, res in results.items():
            lines.append(f"== {prefix} ==")
            cam = res.get("camera")
            if cam:
                lines.append(
                    f"  ATE trans RMSE: {cam['ate_trans_rmse']:.4f} m | "
                    f"rot {cam['ate_rot_deg_rmse']:.3f} deg"
                )
                lines.append(
                    f"  RPE trans RMSE: {cam['rpe_trans_rmse']:.4f} m | "
                    f"rot {cam['rpe_rot_deg_rmse']:.3f} deg"
                )
            om = res.get("objects_mean")
            if om:
                for k, v in sorted(om.items()):
                    lines.append(f"  {k}: {v:.4f}")
            lines.append("")
        ax.text(0.02, 0.98, "\n".join(lines), va="top", family="monospace",
                fontsize=9)
        pdf.savefig(fig)
        plt.close(fig)

        # per-module trajectory pages
        for prefix in results:
            log = os.path.join(output_dir, f"{prefix}_camera_pose_log.csv")
            if not os.path.exists(log):
                continue
            try:
                frames, est, gt = read_pose_log(log)
            except Exception:
                continue
            fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
            plot_trajectory_topdown(axes[0], est, gt, f"{prefix} trajectory")
            if gt is not None:
                rel = np.einsum("nij,njk->nik", np.linalg.inv(gt), est)
                err = np.linalg.norm(rel[:, :3, 3], axis=-1)
                plot_per_frame_errors(
                    axes[1], frames, err, "abs trans err [m]",
                    f"{prefix} per-frame APE"
                )
            fig.tight_layout()
            pdf.savefig(fig)
            plt.close(fig)
    return path


def results_table_markdown(results: Dict) -> str:
    """Result tables (the reference's LaTeX `result_tables.pdf` analog,
    `formatting_utils.py`) as markdown."""
    lines = [
        "| module | ATE t [m] | ATE r [deg] | RPE t [m] | AME t [m] | AME r [deg] | RME t [m] |",
        "|---|---|---|---|---|---|---|",
    ]
    for prefix, res in results.items():
        cam = res.get("camera", {})
        om = res.get("objects_mean", {})
        def g(d, k):
            v = d.get(k)
            return f"{v:.4f}" if isinstance(v, float) else "-"
        lines.append(
            f"| {prefix} | {g(cam,'ate_trans_rmse')} | {g(cam,'ate_rot_deg_rmse')} "
            f"| {g(cam,'rpe_trans_rmse')} | {g(om,'ame_trans_rmse')} "
            f"| {g(om,'ame_rot_deg_rmse')} | {g(om,'rme_trans_rmse')} |"
        )
    return "\n".join(lines)


def _fmt4(v) -> str:
    return f"{v:.4f}" if isinstance(v, (int, float)) else "-"


def results_table_latex(results: Dict) -> str:
    """LaTeX result tables — the analog of the reference's pylatex
    `result_tables.pdf` (`evaluation/formatting_utils.py:62-210`): per
    module, a camera ATE/RPE `|c|cc|` table and a per-object motion-error
    `|c|cc|cc|` table (AME/RME translation + rotation, plus the
    over-objects mean row).  Returned as one standalone compilable
    document (no pylatex dependency; plain strings)."""
    L = [
        r"\documentclass{article}",
        r"\usepackage[margin=2cm]{geometry}",
        r"\begin{document}",
    ]
    for prefix, res in results.items():
        name = prefix.replace("_", r"\_")
        L.append(rf"\section*{{{name}}}")
        cam = res.get("camera")
        if cam:
            L += [
                r"\subsection*{Camera}",
                r"\begin{tabular}{|c|cc|}",
                r"\hline",
                r"metric & translation [m] & rotation [deg] \\",
                r"\hline\hline",
                rf"ATE & {_fmt4(cam.get('ate_trans_rmse'))} & "
                rf"{_fmt4(cam.get('ate_rot_deg_rmse'))} \\",
                rf"RPE & {_fmt4(cam.get('rpe_trans_rmse'))} & "
                rf"{_fmt4(cam.get('rpe_rot_deg_rmse'))} \\",
                r"\hline",
                r"\end{tabular}",
            ]
        objs = res.get("objects")
        if objs:
            L += [
                r"\subsection*{Object motions}",
                r"\begin{tabular}{|c|cc|cc|}",
                r"\hline",
                r"object & AME t [m] & AME r [deg] & RME t [m] & "
                r"RME r [deg] \\",
                r"\hline\hline",
            ]
            for obj in sorted(objs):
                e = objs[obj]
                L.append(
                    rf"{obj} & {_fmt4(e.get('ame_trans_rmse'))} & "
                    rf"{_fmt4(e.get('ame_rot_deg_rmse'))} & "
                    rf"{_fmt4(e.get('rme_trans_rmse'))} & "
                    rf"{_fmt4(e.get('rme_rot_deg_rmse'))} \\"
                )
            om = res.get("objects_mean", {})
            L += [
                r"\hline",
                rf"mean & {_fmt4(om.get('ame_trans_rmse'))} & "
                rf"{_fmt4(om.get('ame_rot_deg_rmse'))} & "
                rf"{_fmt4(om.get('rme_trans_rmse'))} & "
                rf"{_fmt4(om.get('rme_rot_deg_rmse'))} \\",
                r"\hline",
                r"\end{tabular}",
            ]
    L.append(r"\end{document}")
    return "\n".join(L)


def write_result_tables(output_dir: str, results: Dict) -> str:
    """Write `result_tables.tex` (and compile to PDF when a `pdflatex`
    binary exists, mirroring the reference's `save_pdf`; silently skipped
    otherwise — this environment has no TeX)."""
    import shutil
    import subprocess

    tex_path = os.path.join(output_dir, "result_tables.tex")
    with open(tex_path, "w") as f:
        f.write(results_table_latex(results))
    if shutil.which("pdflatex"):
        subprocess.run(
            ["pdflatex", "-interaction=batchmode", "result_tables.tex"],
            cwd=output_dir, capture_output=True, check=False,
        )
    return tex_path


def aggregate_runs(run_dirs, out_path: Optional[str] = None) -> Dict:
    """Aggregate results.json across runs (the reference's
    `make_stats_over_all_runs.py`)."""
    import json

    combined = {}
    for d in run_dirs:
        p = os.path.join(d, "results.json")
        if not os.path.exists(p):
            continue
        with open(p) as f:
            combined[os.path.basename(os.path.normpath(d))] = json.load(f)
    summary = {"runs": combined, "tables": {}}
    for name, res in combined.items():
        summary["tables"][name] = results_table_markdown(res)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(summary, f, indent=2, default=float)
    return summary
