"""Figure plotting for qualitative results.

Matplotlib rework of the reference's plot/ tooling (plot/qvhl.py:35-330):
per-query MR window + saliency-curve figures from prediction/GT jsonls.
Offline tooling -- not part of the runtime path. A copy of
``univtg_tpu/tools/plots.py``; matplotlib (and cv2, PIL for the frame
strips) are imported inside the functions, so importing the module needs
none of them.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def plot_query(
    pred_row: dict,
    gt_row: Optional[dict] = None,
    clip_len: float = 2.0,
    out_path: Optional[str] = None,
    baseline_row: Optional[dict] = None,
):
    """One query -> figure: saliency curve + top predicted windows vs GT.

    Args:
      pred_row: submission row (pred_relevant_windows, pred_saliency_scores).
      gt_row: optional GT row (relevant_windows, saliency_scores, duration).
      baseline_row: optional second submission row for comparison.
    Returns the matplotlib Figure.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax_sal, ax_win) = plt.subplots(
        2, 1, figsize=(10, 4), sharex=True, height_ratios=[2, 1]
    )
    sal = np.asarray(pred_row["pred_saliency_scores"], np.float64)
    t = np.arange(len(sal)) * clip_len + clip_len / 2
    ax_sal.plot(t, sal, label="pred saliency", color="#1f77b4")
    if gt_row is not None and isinstance(gt_row.get("saliency_scores"), list):
        gt_sal = np.zeros(len(sal))
        ids = np.asarray(gt_row["relevant_clip_ids"])
        vals = np.mean(np.asarray(gt_row["saliency_scores"], np.float64), axis=1)
        keep = ids < len(sal)
        gt_sal[ids[keep]] = vals[keep]
        ax_sal.plot(t, gt_sal / 4.0 * (sal.max() - sal.min() + 1e-6) + sal.min(),
                    label="gt saliency (scaled)", color="#2ca02c", alpha=0.7)
    ax_sal.legend(loc="upper right", fontsize=8)
    ax_sal.set_ylabel("saliency")
    ax_sal.set_title(str(pred_row.get("query", pred_row.get("qid", ""))), fontsize=9)

    def draw_windows(rows, y, color, label):
        first = True
        for w in rows:
            ax_win.barh(y, w[1] - w[0], left=w[0], height=0.6, color=color,
                        alpha=0.8, label=label if first else None)
            first = False

    draw_windows(pred_row["pred_relevant_windows"][:3], 2, "#1f77b4", "pred top-3")
    if baseline_row is not None:
        draw_windows(baseline_row["pred_relevant_windows"][:3], 1, "#ff7f0e", "baseline")
    if gt_row is not None:
        draw_windows(gt_row.get("relevant_windows", []), 0, "#2ca02c", "gt")
    ax_win.set_yticks([])
    ax_win.set_xlabel("time (s)")
    ax_win.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, dpi=120)
    return fig


# ---------------------------------------------------------------- paper style
# Colors follow the reference's palette roles (plot/qvhl.py settings): GT
# green, prediction blue, baseline a third hue; each with a darker edge.
_PAPER = {
    "gt": ("#90ee90", "#2e8b57"),
    "pred": ("#add8e6", "#1f6fb4"),
    "base": ("#ffcf9e", "#c45508"),
}


def _minmax(x):
    x = np.asarray(x, np.float64)
    lo, hi = x.min(), x.max()
    return (x - lo) / (hi - lo + 1e-9)


def _label_ends(ax, row, st, ed, duration, color):
    offset = duration * 0.01
    if st > 2 * offset:
        ax.text(st, row, f"{st:.1f}", va="center", ha="right", color=color, fontsize=11)
    if ed < duration - offset:
        ax.text(ed, row, f"{ed:.1f}", va="center", ha="left", color=color, fontsize=11)


def plot_mr_paper(pred_row, gt_row, out_path=None, baseline_row=None, pred_num=None):
    """Paper-style MR bar chart (plot/qvhl.py:92-194): one horizontal track
    per system (GT on top, prediction, optional baseline), white full-length
    base bars with black edges, start/end timestamps labeled at the bar ends,
    track names drawn inside the track."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    duration = float(gt_row["duration"])
    rows = [("GT Interval", gt_row["relevant_windows"], _PAPER["gt"])]
    rows.append(
        ("UniVTG's Prediction", pred_row["pred_relevant_windows"], _PAPER["pred"])
    )
    if baseline_row is not None:
        rows.append(
            ("Baseline's Prediction", baseline_row["pred_relevant_windows"],
             _PAPER["base"])
        )
    n = pred_num if pred_num is not None else len(gt_row["relevant_windows"])

    fig, ax = plt.subplots(1, 1, figsize=(25, 1 + len(rows) * 0.7))
    ys = list(range(len(rows)))[::-1]  # GT on top
    for y in ys:
        ax.barh(y, duration, left=0, height=0.6, color="white",
                edgecolor="black", linewidth=2)
    for y, (name, windows, (fill, dark)) in zip(ys, rows):
        for w in windows[:n]:
            st, ed = float(w[0]), float(w[1])
            ax.barh(y, ed - st, left=st, height=0.6, color=fill,
                    edgecolor=dark, linewidth=2)
            _label_ends(ax, y, st, ed, duration, dark)
        ax.text(duration * 0.005, y, f"  {name}", va="center", ha="left",
                color=dark, fontsize=13, fontweight="bold")
    off = duration * 0.01
    ax.text(off, -0.75, "0.0", va="center", ha="center", fontsize=11)
    ax.text(duration - off, -0.75, f"{duration:.1f}", va="center", ha="center",
            fontsize=11)
    ax.set_xlim(0, duration)
    ax.set_ylim(-1, len(rows) - 0.4)
    ax.set_xticks([])
    ax.set_yticks([])
    for spine in ax.spines.values():
        spine.set_visible(False)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, bbox_inches="tight", pad_inches=0.2, dpi=100)
    return fig


def _gt_saliency_curve(gt_row, length):
    gt = np.zeros(length)
    ids = np.asarray(gt_row.get("relevant_clip_ids", []), int)
    scores = gt_row.get("saliency_scores")
    if scores is not None and len(ids):
        vals = np.asarray(scores, np.float64)
        vals = vals.mean(axis=-1) if vals.ndim > 1 else vals
        keep = ids < length
        gt[ids[keep]] = _minmax(vals)[keep]
    return gt


def plot_hl_paper(pred_row, gt_row=None, out_path=None, baseline_row=None,
                  clip_len: float = 2.0, gap: Optional[float] = None):
    """Paper-style saliency comparison (plot/qvhl.py:209-263): min-max
    normalized curves for GT / prediction / optional baseline with colored
    legend text and periodic time labels. ``gt_row=None`` renders the
    prediction-vs-baseline-only variant (plot/tvsum.py:92-157 -- the TVSum
    figures have no per-query GT row)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pred = _minmax(pred_row["pred_saliency_scores"])
    L = len(pred)
    duration = (
        float(gt_row["duration"]) if gt_row is not None else L * clip_len
    )
    x = np.arange(L) * clip_len
    fig, ax = plt.subplots(1, 1, figsize=(25, 2.2))
    if gt_row is not None:
        ax.plot(x, _gt_saliency_curve(gt_row, L), label="GT Saliency",
                color=_PAPER["gt"][1], linewidth=4)
    ax.plot(x, pred, label="UniVTG's Prediction", color=_PAPER["pred"][1],
            linewidth=4)
    if baseline_row is not None:
        base = np.asarray(baseline_row["pred_saliency_scores"], np.float64)
        ax.plot(x[: len(base)], _minmax(base)[:L],
                label="Baseline's Prediction", color=_PAPER["base"][1],
                linewidth=4)
    if gap:
        for t in np.arange(0, duration + gap / 2, gap)[1:-1]:
            ax.text(t, -0.2, f"{t:.1f}", va="center", ha="center", fontsize=11)
    off = duration * 0.01
    ax.text(off, -0.2, "0.0", va="center", ha="center", fontsize=11)
    ax.text(duration - clip_len - off, -0.2, f"{duration:.1f}", va="center",
            ha="center", fontsize=11)
    ax.set_xlim(0, max(duration - clip_len, x[-1] if L else 1.0))
    ax.set_xticks([])
    ax.set_yticks([])
    legend = ax.legend(loc="upper left", bbox_to_anchor=(0, 1.15), ncol=3,
                       frameon=False, fontsize=13)
    for line, text in zip(legend.get_lines(), legend.get_texts()):
        text.set_color(line.get_color())
    for pos in ("top", "right"):
        ax.spines[pos].set_visible(False)
    for pos in ("bottom", "left"):
        ax.spines[pos].set_linewidth(2)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, bbox_inches="tight", pad_inches=0.2, dpi=100)
    return fig


def apply_template(frame, template_path):
    """Composite an RGBA template PNG over a frame (plot/qvhl.py:21-33):
    the frame is pasted onto a white canvas 1.4x its height (offset 19%
    down) and the template is alpha-composited full-canvas on top -- the
    reference uses this to draw the film-strip sprocket border on paper
    figures. Returns an RGB numpy array."""
    from PIL import Image

    frame = Image.fromarray(frame)
    template = Image.open(template_path).convert("RGBA")
    width, height = frame.size
    new_size = (width, int(height * 1.4))
    canvas = Image.new("RGBA", new_size, (255, 255, 255, 255))
    canvas.paste(frame, (0, int(height * 0.19)))
    template = template.resize(new_size, Image.LANCZOS)
    return np.array(Image.alpha_composite(canvas, template).convert("RGB"))


def plot_frame_strip(video_path, duration, query, out_path=None,
                     n_frames=None, template_path=None):
    """Frame strip with the query as a banner (plot/qvhl.py:35-89, sans the
    PIL font pipeline -- matplotlib renders the text). Optional
    ``template_path`` overlays the reference's film-strip template on each
    frame (apply_template). Returns None when the video file is absent
    (figures still render without the strip)."""
    if not os.path.exists(video_path):
        return None
    import cv2
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if n_frames is None:
        n_frames = max(2, round(duration / 10))
    cap = cv2.VideoCapture(video_path)
    frames = []
    for t in np.linspace(0, max(duration - 0.5, 0.0), n_frames):
        cap.set(cv2.CAP_PROP_POS_MSEC, t * 1e3)
        ok, frame = cap.read()
        if not ok:
            break
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if template_path and os.path.exists(template_path):
            frame = apply_template(frame, template_path)
        frames.append(frame)
    cap.release()
    if not frames:
        return None
    fig, axs = plt.subplots(1, len(frames), figsize=(25, 3),
                            gridspec_kw={"wspace": 0.0, "hspace": 0.0})
    if len(frames) == 1:
        axs = [axs]
    for ax, frame in zip(axs, frames):
        ax.imshow(frame)
        ax.axis("off")
    fig.suptitle(f"QUERY: {query}", fontsize=15, y=1.02)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, bbox_inches="tight", pad_inches=0.1, dpi=100)
    return fig


def render_comparison(pred_row, gt_row, out_dir, baseline_row=None,
                      video_path=None, clip_len: float = 2.0,
                      seg_num: int = 15, pred_num=None,
                      template_path=None, include=("vid", "mr", "hl")):
    """One query -> the reference's per-sample figure set (plot/qvhl.py
    plot_sample, :265-295): {iou}_{n_windows}_{vid}_{qid}/ containing
    1_mr.jpg, 2_hl.jpg, optional 0_vid.jpg, and combined.jpg.

    ``include`` selects the parts, covering the per-dataset variants of
    the reference's plot/ scripts: ("vid", "mr") is the ego4d/tacos
    MR-only figure (plot/ego4d.py:282-284 -- plot_hl commented out);
    ("vid", "hl") is the TVSum/YouTube HL figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    iou = _iou_safe(np.asarray(pred_row["pred_relevant_windows"][0][:2], np.float32),
                    np.asarray(gt_row["relevant_windows"][0], np.float32))
    name = "_".join(
        [f"{round(iou, 2)}", str(len(gt_row["relevant_windows"])),
         str(gt_row.get("vid", "vid")), str(gt_row.get("qid", "q"))]
    )
    save_dir = os.path.join(out_dir, name)
    os.makedirs(save_dir, exist_ok=True)

    gap = round(float(gt_row["duration"]) / seg_num) or None
    parts = []
    if video_path and "vid" in include:
        f = plot_frame_strip(
            video_path, float(gt_row["duration"]),
            pred_row.get("query", gt_row.get("query", "")),
            os.path.join(save_dir, "0_vid.jpg"),
            template_path=template_path,
        )
        if f is not None:
            parts.append(os.path.join(save_dir, "0_vid.jpg"))
            plt.close(f)
    if "mr" in include:
        f = plot_mr_paper(pred_row, gt_row, os.path.join(save_dir, "1_mr.jpg"),
                          baseline_row, pred_num)
        plt.close(f)
        parts.append(os.path.join(save_dir, "1_mr.jpg"))
    if "hl" in include:
        f = plot_hl_paper(pred_row, gt_row, os.path.join(save_dir, "2_hl.jpg"),
                          baseline_row, clip_len, gap)
        plt.close(f)
        parts.append(os.path.join(save_dir, "2_hl.jpg"))

    import matplotlib.image as mpimg

    images = [mpimg.imread(p) for p in parts]
    heights = [im.shape[0] / im.shape[1] for im in images]
    fig, axs = plt.subplots(len(images), 1, figsize=(25, 25 * sum(heights)),
                            gridspec_kw={"height_ratios": heights})
    if len(images) == 1:
        axs = [axs]
    for ax, im in zip(axs, images):
        ax.imshow(im)
        ax.axis("off")
    fig.subplots_adjust(hspace=0.02)
    fig.savefig(os.path.join(save_dir, "combined.jpg"), bbox_inches="tight",
                pad_inches=0.1, dpi=80)
    plt.close(fig)
    return save_dir


def _iou_safe(a, b, eps=1e-12) -> float:
    """IoU of two xx windows in float32, 0 where their union is 0 (the JAX
    package's ``iou_cross_safe`` on one pair)."""
    inter = max(np.float32(0), min(a[1], b[1]) - max(a[0], b[0]))
    union = (a[1] - a[0]) + (b[1] - b[0]) - inter
    return float(inter / union) if union > eps else 0.0


def seconds_to_hms(seconds: float) -> str:
    """0 -> '0:00:00' (plot/qfvs.py:24-25; hour-long egocentric videos)."""
    seconds = int(seconds)
    return f"{seconds // 3600}:{(seconds % 3600) // 60:02d}:{seconds % 60:02d}"


def plot_vs_paper(pred_row, out_path=None, shot_seconds: float = 5.0):
    """QFVS summary-selection figure (plot/qfvs.py:115-215): two stacked
    shot tracks -- GT summary shots (top) and the predicted top-2% shots
    (bottom) as filled cells on a white black-bordered strip, with
    H:MM:SS end labels (5 s shots).

    pred_row: {"top_pred": [shot ids], "gt": [shot ids], "shots": N}.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import patches

    total = int(pred_row["shots"])
    tracks = [
        ("GT Summary", np.asarray(pred_row["gt"], int), _PAPER["gt"][1]),
        ("UniVTG's Summary", np.asarray(pred_row["top_pred"], int),
         _PAPER["pred"][1]),
    ]
    fig, axes = plt.subplots(
        2, 1, figsize=(50, 2),
        gridspec_kw={"height_ratios": [1, 1], "hspace": 0.05},
    )
    for ax, (name, ids, color) in zip(axes, tracks):
        colors = ["white"] * total
        for i in ids[ids < total]:
            colors[int(i)] = color
        ax.bar(range(total), np.ones(total), color=colors, width=2,
               label=name)
        ax.axis("off")
        ax.add_patch(patches.Rectangle((0, 0), total, 1, linewidth=1,
                                       edgecolor="black", facecolor="none"))
        legend = ax.legend(loc="upper right", handlelength=0, fontsize=13)
        for text in legend.get_texts():
            text.set_color(color)
        ax.set_xlim(left=0, right=total)
    off = total * 0.01
    axes[1].text(off, -0.3, seconds_to_hms(0), va="center", ha="center",
                 fontsize=11)
    axes[1].text(total - off, -0.3, seconds_to_hms(total * shot_seconds),
                 va="center", ha="center", fontsize=11)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, bbox_inches="tight", pad_inches=0.2, dpi=100)
    return fig


def plot_comparison_set(pred_jsonl, gt_jsonl, out_dir, baseline_jsonl=None,
                        video_dir=None, max_queries: int = 10,
                        clip_len: float = 2.0, pred_num=None,
                        template_path=None):
    """Paper-figure batch driver over submission jsonls (the reference ships
    plot/qvhl/{univtg,momentdetr,gt}.jsonl as inputs for exactly this)."""
    from univtg_tpu_torch.data.features import load_jsonl

    preds = load_jsonl(pred_jsonl)
    gts = {r["qid"]: r for r in load_jsonl(gt_jsonl)}
    bases = (
        {r["qid"]: r for r in load_jsonl(baseline_jsonl)} if baseline_jsonl else {}
    )
    made = []
    for row in preds:
        gt = gts.get(row["qid"])
        if gt is None:
            continue
        video_path = (
            os.path.join(video_dir, f"{gt.get('vid', '')}.mp4") if video_dir else None
        )
        made.append(
            render_comparison(
                row, gt, out_dir, bases.get(row["qid"]), video_path,
                clip_len, pred_num=pred_num, template_path=template_path,
            )
        )
        if len(made) >= max_queries:
            break
    return made


def plot_submission(
    pred_jsonl: str,
    gt_jsonl: Optional[str],
    out_dir: str,
    max_queries: int = 20,
    clip_len: float = 2.0,
    baseline_jsonl: Optional[str] = None,
):
    """Dump per-query figures for the first max_queries queries."""
    import matplotlib.pyplot as plt

    from univtg_tpu_torch.data.features import load_jsonl

    preds = load_jsonl(pred_jsonl)[:max_queries]
    gts = {r["qid"]: r for r in load_jsonl(gt_jsonl)} if gt_jsonl else {}
    baselines = (
        {r["qid"]: r for r in load_jsonl(baseline_jsonl)} if baseline_jsonl else {}
    )
    os.makedirs(out_dir, exist_ok=True)
    for row in preds:
        fig = plot_query(
            row,
            gts.get(row["qid"]),
            clip_len,
            os.path.join(out_dir, f"{row['qid']}.png"),
            baselines.get(row["qid"]),
        )
        plt.close(fig)
    return len(preds)
