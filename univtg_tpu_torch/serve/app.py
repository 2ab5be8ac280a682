"""Interactive demo app (gradio Blocks); counterpart of
``univtg_tpu/serve/app.py``, after the upstream main_gradio.py flow:
upload/extract a video -> type a query -> grounded Top-1 interval + Top-5
windows + Top-1 highlight.

gradio is an optional dependency, imported only inside `launch_app`, which
raises a clear error when it is absent. The compute path is the serving
pipeline's (GroundingPipeline with a clip_encoder). The callbacks are built
separately (`build_callbacks`) so the demo logic is testable without
gradio, and `launch_app` accepts an injected gradio module for the same
reason.
"""
from __future__ import annotations

import os
import subprocess
from typing import Optional


def download_video(video_id_or_url: str, save_path: str, size: int = 768) -> str:
    """Fetch a YouTube video via the yt-dlp CLI (the reference demo's
    download helper, main_gradio.py:129-137). Accepts a bare video id or a
    full URL; returns save_path. Raises FileNotFoundError when yt-dlp is not
    installed and RuntimeError when the download fails."""
    url = video_id_or_url
    if "://" not in url:
        url = f"https://www.youtube.com/watch?v={url}"
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    cmd = [
        "yt-dlp",
        "-S", "ext:mp4:m4a",
        "--throttled-rate", "5M",
        "-f", f"best[width<={size}][height<={size}]",
        "--output", save_path,
        "--merge-output-format", "mp4",
        url,
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except FileNotFoundError as e:
        raise FileNotFoundError(
            "yt-dlp is not installed; download the video manually and pass "
            "its local path"
        ) from e
    if proc.returncode != 0:
        raise RuntimeError(f"yt-dlp failed (rc={proc.returncode}): {proc.stderr[-500:]}")
    return save_path


def build_callbacks(pipeline):
    """(extract, ground) demo callbacks over a GroundingPipeline with a
    clip_encoder. `extract(video_path_or_youtube_id)` caches clip features;
    `ground(query)` grounds the query against the cached video
    (main_gradio.py:82-155 behavior, shared state between the two events)."""
    from univtg_tpu_torch.extract.pipeline import txt2clip, vid2clip

    state = {"features": None, "video": None}

    def extract(video_path, workdir: Optional[str] = None):
        if not video_path:
            return "Upload a video first."
        if not os.path.exists(video_path):
            # bare YouTube id typed into the video box (main_gradio.py:201):
            # ids are exactly 11 URL-safe chars -- anything else that doesn't
            # exist on disk is a typo'd path, not a download request
            import re

            if "://" in video_path or re.fullmatch(r"[A-Za-z0-9_-]{11}", video_path):
                video_path = download_video(
                    video_path, os.path.join(workdir or ".", "input.mp4")
                )
            else:
                return f"File not found: {video_path}"
        state["features"] = vid2clip(
            pipeline.clip_encoder, video_path, clip_len=pipeline.clip_len
        )
        state["video"] = video_path
        n = len(state["features"])
        return f"Extracted {n} clip features ({n * pipeline.clip_len:.0f}s video)."

    def ground(query):
        if state["features"] is None:
            return "Extract a video first."
        txt = txt2clip(pipeline.clip_encoder, query)
        result = pipeline.ground_features(state["features"], txt)
        lines = [pipeline.describe(result, query), "", "Top-5 windows:"]
        for st, ed, sc in result["topk_windows"]:
            lines.append(f"  [{st:8.2f}s, {ed:8.2f}s]  conf {sc:.3f}")
        return "\n".join(lines)

    return extract, ground


def launch_app(pipeline, server_port: int = 7860, share: bool = False,
               example_video: Optional[str] = None, gr=None):
    """pipeline: univtg_tpu_torch.serve.GroundingPipeline with a clip_encoder.
    `gr` injects a gradio-compatible module (tests use a stub)."""
    if gr is None:
        try:
            import gradio as gr
        except ImportError as e:
            raise ImportError(
                "gradio is not installed; use `python -m univtg_tpu_torch.cli ground` "
                "for the CLI demo path"
            ) from e

    extract, ground = build_callbacks(pipeline)

    with gr.Blocks(title="univtg_tpu grounding demo") as demo:
        gr.Markdown("## Video-language temporal grounding")
        with gr.Row():
            video = gr.Video(label="video", value=example_video)
            with gr.Column():
                extract_btn = gr.Button("Extract features")
                status = gr.Textbox(label="status", interactive=False)
                query = gr.Textbox(label="query")
                ground_btn = gr.Button("Ground")
                answer = gr.Textbox(label="result", interactive=False, lines=10)
        extract_btn.click(extract, inputs=video, outputs=status)
        ground_btn.click(ground, inputs=query, outputs=answer)
    demo.launch(server_port=server_port, share=share)
    return demo
