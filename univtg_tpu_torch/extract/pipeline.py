"""Feature extraction: video/text -> CLIP features -> npz; counterpart of
``univtg_tpu/extract/pipeline.py``.

Frames go through the image tower in fixed batches of ``image_batch`` and
texts through the text tower in batches of ``text_batch``, the last batch
zero-padded: a frame's features then do not depend on the video's length,
and cuBLAS sees one shape per tower. Raw uint8 frames travel to the card as
uint8 and are normalized there (4x fewer bytes than f32).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from univtg_tpu_torch.device import resolve_device
from univtg_tpu_torch.extract import video
from univtg_tpu_torch.extract.clip.model import CLIP, CLIPConfig
from univtg_tpu_torch.extract.clip.tokenizer import tokenize
from univtg_tpu_torch.extract.video import CLIP_MEAN, CLIP_STD


class ClipEncoder:
    """Batched CLIP encoders with padded fixed batch shapes."""

    def __init__(self, params, cfg: CLIPConfig, image_batch: int = 64,
                 text_batch: int = 32, device="cuda"):
        """params: a CLIP state_dict (e.g. from ``load_clip_checkpoint``) or a
        ``CLIP`` module. ``device`` defaults to CUDA and raises when there is
        none; pass device='cpu' to encode on the CPU. The towers compute in
        ``cfg.compute_dtype`` ("float32" or "bfloat16")."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.image_batch = image_batch
        self.text_batch = text_batch
        if isinstance(params, nn.Module):
            params = params.state_dict()
        model = CLIP(cfg, device="meta")
        model.load_state_dict({k: v.to(self.device) for k, v in params.items()},
                              strict=True, assign=True)
        self.model = model.requires_grad_(False)
        self._mean = torch.from_numpy(CLIP_MEAN).to(self.device)
        self._std = torch.from_numpy(CLIP_STD).to(self.device)

    @torch.inference_mode()
    def _encode_image(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.uint8:
            # /255 and CLIP mean/std on the card
            x = (x.float() / 255.0 - self._mean) / self._std
        return self.model.encode_image(x)

    @torch.inference_mode()
    def _encode_text(self, tokens: torch.Tensor) -> dict:
        return self.model.encode_text(tokens)

    def _batches(self, a: np.ndarray, size: int):
        """(device batch padded with zeros to ``size`` rows, real rows)."""
        for i in range(0, len(a), size):
            chunk = a[i:i + size]
            n = len(chunk)
            if n < size:
                chunk = np.concatenate([chunk, np.zeros((size - n,) + chunk.shape[1:],
                                                        chunk.dtype)])
            yield torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device), n

    def encode_images(self, frames: np.ndarray) -> np.ndarray:
        """(T, H, W, 3) frames -> (T, embed_dim) f32 features.

        Takes pre-normalized float32 frames (preprocess_frames) or raw uint8
        frames, which are normalized on the card."""
        out = [self._encode_image(x)[:n] for x, n in self._batches(frames, self.image_batch)]
        if not out:
            return np.zeros((0, self.cfg.embed_dim), np.float32)
        return torch.cat(out).float().cpu().numpy()

    def encode_texts(self, texts: Sequence[str], max_valid_length: int = 32):
        """Texts -> list of (L_i, width) last_hidden_state arrays (valid
        positions only: up to EOT) + (N, embed_dim) pooled features."""
        tokens = tokenize(list(texts), self.cfg.context_length, max_valid_length)
        hidden, pooled = [], []
        for x, n in self._batches(tokens, self.text_batch):
            out = self._encode_text(x)
            hidden.append(out["last_hidden_state"][:n].float().cpu().numpy())
            pooled.append(out["pooler_output"][:n].float().cpu().numpy())
        rows = np.concatenate(hidden) if hidden else []
        # EOT position + 1: the first argmax of the ids
        hidden = [row[: int(np.argmax(tok)) + 1] for row, tok in zip(rows, tokens)]
        pooled = (np.concatenate(pooled) if pooled
                  else np.zeros((0, self.cfg.embed_dim), np.float32))
        return hidden, pooled


def vid2clip(encoder: ClipEncoder, video_path: str, save_dir: Optional[str] = None,
             clip_len: float = 2.0) -> np.ndarray:
    """Video file -> (T, embed_dim) clip features, one frame per clip_len
    seconds (``video.decode_frames``, reached through its module); the frames
    go to the card as raw uint8."""
    frames, _ = video.decode_frames(video_path, clip_len=clip_len)
    feats = encoder.encode_images(frames)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        np.savez(os.path.join(save_dir, "vid.npz"), features=feats)
    return feats


def txt2clip(encoder: ClipEncoder, text: str, save_dir: Optional[str] = None) -> np.ndarray:
    """Query -> (L, width) token features."""
    hidden, _ = encoder.encode_texts([text])
    feats = hidden[0]
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        np.savez(os.path.join(save_dir, "txt.npz"), features=feats)
    return feats


def extract_query_features(
    encoder: ClipEncoder, rows: List[dict], out_dir: str, max_valid_length: int = 32
):
    """Offline per-dataset query dump: jsonl rows ->
    {qid}.npz[last_hidden_state] (upstream run_on_video/text_extractor.py)."""
    os.makedirs(out_dir, exist_ok=True)
    hidden, _ = encoder.encode_texts([r["query"] for r in rows], max_valid_length)
    for row, h in zip(rows, hidden):
        np.savez(os.path.join(out_dir, f"{row['qid']}.npz"), last_hidden_state=h)
