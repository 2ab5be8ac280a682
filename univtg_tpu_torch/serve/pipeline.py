"""Serving: the grounding core shared by the CLI server and direct callers.

Counterpart of ``univtg_tpu/serve/pipeline.py``. L2-normalized features +
TEF + timestamp grid -> model forward -> dense decode -> top-k windows
ranked by foreground confidence + argmax highlight. Feature lengths pad to
a bucket ladder and the batch to powers of two, as in the JAX package, so
the card sees a few shapes however the traffic varies. With a
``clip_encoder`` (extract/pipeline.ClipEncoder) ``ground_video`` grounds a
query in a raw video file, as the upstream demo does.
"""
from __future__ import annotations

import time
from collections.abc import Mapping
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from univtg_tpu_torch.core.padding import bucket_length, default_buckets
from univtg_tpu_torch.data.features import l2_normalize
from univtg_tpu_torch.data.mr import tef_features, timestamp_grid
from univtg_tpu_torch.device import resolve_device
from univtg_tpu_torch.models import ModelConfig, UniVTG
from univtg_tpu_torch.train.steps import decode_dense_outputs

TEXT_BUCKETS = (32, 77)


def hms(seconds: float) -> str:
    return time.strftime("%H:%M:%S", time.gmtime(seconds))


class PreparedVideo:
    """Bucket-padded video arrays, ready to batch into a forward pass.
    Prepared once per video and reused across every query that targets it."""

    __slots__ = ("vid", "vid_mask", "ts", "ctx_l", "bucket")

    def __init__(self, vid, vid_mask, ts, ctx_l, bucket):
        self.vid = vid
        self.vid_mask = vid_mask
        self.ts = ts
        self.ctx_l = ctx_l
        self.bucket = bucket


class GroundingPipeline:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        clip_len: float = 2.0,
        buckets: Optional[Sequence[int]] = None,
        clip_encoder=None,
        eval_mode: Optional[str] = None,
        param_dtype: Optional[str] = None,
        device="cuda",
    ):
        """params: a state_dict (e.g. from ``load_torch_checkpoint``) or a
        ``UniVTG`` module whose weights are served. clip_encoder: an optional
        ClipEncoder, which ``ground_video`` needs.

        eval_mode=None ranks by raw saliency; 'add' adds the foreground
        probability, as the batch evaluator does. param_dtype='bfloat16'
        casts the float weights once here (half the weight memory); None
        keeps the checkpoint's precision. ``device`` defaults to CUDA and
        raises when there is none; pass device='cpu' to serve on the CPU."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.param_dtype = param_dtype
        self.clip_len = clip_len
        self.buckets = list(buckets or default_buckets(2048, base=128))
        self.clip_encoder = clip_encoder
        self.eval_mode = eval_mode
        if isinstance(params, nn.Module):
            params = params.state_dict()
        self.model = self._build(params)

    def _served_dtype(self, t: torch.Tensor) -> torch.dtype:
        if self.param_dtype is None or not t.is_floating_point():
            return t.dtype
        return getattr(torch, self.param_dtype)

    def _build(self, state_dict: Mapping) -> UniVTG:
        """A fresh model holding ``state_dict`` (cast to param_dtype) on the
        device; load_state_dict checks every key and shape."""
        model = UniVTG(self.cfg, device="meta")
        sd = {
            k: v.to(device=self.device, dtype=self._served_dtype(v))
            for k, v in state_dict.items()
        }
        model.load_state_dict(sd, strict=True, assign=True)
        return model.requires_grad_(False)

    def swap_params(self, state_dict: Mapping):
        """Hot-swap the served weights without a restart.

        Applies the constructor's param_dtype cast, then checks keys, shapes
        AND dtypes against the served model. The swap is one attribute
        assignment (atomic under the GIL): a dispatch already running keeps
        the old model, later ones use the new. Raises ValueError on any
        mismatch and leaves the served weights untouched."""
        old = self.model.state_dict()
        if set(state_dict) != set(old):
            extra = sorted(set(state_dict) - set(old))[:3]
            missing = sorted(set(old) - set(state_dict))[:3]
            raise ValueError(
                f"checkpoint keys do not match the served model: "
                f"missing {missing}, unexpected {extra}"
            )
        for k, n in state_dict.items():
            o = old[k]
            n_dtype = self._served_dtype(n)
            if tuple(n.shape) != tuple(o.shape) or n_dtype != o.dtype:
                raise ValueError(
                    f"checkpoint tensor {k}: got {tuple(n.shape)}/{n_dtype}, "
                    f"serving {tuple(o.shape)}/{o.dtype}"
                )
        self.model = self._build(state_dict)

    def prepare_video(self, vid_feats: np.ndarray) -> PreparedVideo:
        """(T, Dv) clip features -> bucket-padded arrays: L2-normalize, THEN
        truncate to the top bucket, append TEF, pad to the bucket."""
        vid = l2_normalize(np.asarray(vid_feats, np.float32))
        if len(vid) > self.buckets[-1]:
            vid = vid[: self.buckets[-1]]
        ctx_l = len(vid)
        ts = timestamp_grid(ctx_l, self.clip_len)
        vid = np.concatenate([vid, tef_features(ctx_l)], axis=1)

        Lb = bucket_length(ctx_l, self.buckets)
        pad = Lb - ctx_l
        vid = np.pad(vid, ((0, pad), (0, 0)))
        ts = np.pad(ts, ((0, pad), (0, 0)))
        vid_mask = np.zeros(Lb, np.float32)
        vid_mask[:ctx_l] = 1
        return PreparedVideo(vid, vid_mask, ts, ctx_l, Lb)

    def _prepare_txt(self, txt_feats: np.ndarray):
        txt = l2_normalize(np.asarray(txt_feats, np.float32))
        Lt = bucket_length(len(txt), TEXT_BUCKETS)
        mask = np.zeros(Lt, np.float32)
        mask[: len(txt)] = 1
        txt = np.pad(txt, ((0, Lt - len(txt)), (0, 0)))
        return txt, mask

    def ground_features(self, vid_feats: np.ndarray, txt_feats: np.ndarray,
                        top_k: int = 5):
        """(T, Dv) clip features + (L, Dt) token features -> grounding dict."""
        return self.ground_features_many(vid_feats, [txt_feats], top_k)[0]

    def _decode_row(self, scores, spans, saliency, ctx_l: int, top_k: int):
        scores = scores[:ctx_l]
        duration = ctx_l * self.clip_len
        # clamp like the batch-eval path
        spans = np.clip(spans[:ctx_l] * duration, 0, duration)
        saliency = saliency[:ctx_l]
        order = np.argsort(-scores, kind="stable")[:top_k]
        windows = [[float(spans[i, 0]), float(spans[i, 1]), float(scores[i])]
                   for i in order]
        return {
            "top1_window": windows[0][:2],
            "topk_windows": windows,
            "saliency": saliency,
            "top1_highlight": float(np.argmax(saliency) * self.clip_len),
            "duration": duration,
        }

    def ground_features_many(self, vid_feats: np.ndarray,
                             txt_feats_list: Sequence[np.ndarray],
                             top_k: int = 5):
        """Batch-serve N queries against ONE video, prepared once."""
        if len(txt_feats_list) == 0:
            return []
        pv = self.prepare_video(vid_feats)
        return self.ground_prepared_many([(pv, t) for t in txt_feats_list],
                                         top_k)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.inference_mode()
    def _forward(self, txt, txt_mask, vid, vid_mask, ts):
        out = self.model(txt, txt_mask, vid, vid_mask)
        dec = decode_dense_outputs(out, vid_mask, ts, self.eval_mode)
        return {k: dec[k].float().cpu().numpy()
                for k in ("scores", "spans", "saliency")}

    def ground_prepared_many(self, items: Sequence[tuple], top_k: int = 5):
        """Cross-video batched serving: items are (PreparedVideo, txt_feats)
        pairs. Requests group by (video bucket, text bucket); each group
        runs as ONE forward with the batch padded to a power of two.
        Per-request results equal ground_features."""
        results: list = [None] * len(items)
        groups: dict = {}
        for i, (pv, t) in enumerate(items):
            txt, mask = self._prepare_txt(t)
            groups.setdefault((pv.bucket, txt.shape[0]), []).append(
                (i, pv, txt, mask)
            )
        for group in groups.values():
            n = len(group)
            nb = 1 << (n - 1).bit_length()  # pad batch to the pow-2 ladder
            rows = group + [group[-1]] * (nb - n)
            txt = self._tensor(np.stack([g[2] for g in rows]))
            txt_mask = self._tensor(np.stack([g[3] for g in rows]))
            pvs = [g[1] for g in rows]
            if all(p is pvs[0] for p in pvs):
                # single-video fast path: one copy to the card, then a
                # broadcast view (a long video row is ~20 MB)
                pv0 = pvs[0]
                vid = self._tensor(pv0.vid).expand(nb, -1, -1)
                vid_mask = self._tensor(pv0.vid_mask).expand(nb, -1)
                ts = self._tensor(pv0.ts).expand(nb, -1, -1)
            else:
                vid = self._tensor(np.stack([p.vid for p in pvs]))
                vid_mask = self._tensor(np.stack([p.vid_mask for p in pvs]))
                ts = self._tensor(np.stack([p.ts for p in pvs]))
            out = self._forward(txt, txt_mask, vid, vid_mask, ts)
            for row, (i, pv, _, _) in enumerate(group):
                results[i] = self._decode_row(
                    out["scores"][row], out["spans"][row],
                    out["saliency"][row], pv.ctx_l, top_k,
                )
        return results

    def ground_video(self, video_path: str, query: str, top_k: int = 5):
        """Raw video + text query -> grounding (needs a clip_encoder)."""
        if self.clip_encoder is None:
            raise ValueError("ground_video needs the pipeline constructed with a "
                             "clip_encoder")
        from univtg_tpu_torch.extract.pipeline import txt2clip, vid2clip

        vid_feats = vid2clip(self.clip_encoder, video_path, clip_len=self.clip_len)
        txt_feats = txt2clip(self.clip_encoder, query)
        return self.ground_features(vid_feats, txt_feats, top_k)

    def describe(self, result: dict, query: str) -> str:
        """Human-readable answer, as the upstream demo prints it."""
        mr = " - ".join(hms(int(t)) for t in result["top1_window"])
        return "\n".join(
            [
                f"For query: {query}",
                f"The Top-1 interval is: {mr}",
                f"The Top-1 highlight is: {hms(result['top1_highlight'])}",
            ]
        )
