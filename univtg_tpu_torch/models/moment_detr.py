"""Moment-DETR, the query-based baseline; counterpart of
``univtg_tpu/models/moment_detr.py``.

Shared input projectors -> post-norm encoder over [vid; txt] -> decoder over
``num_queries`` learned slots -> per-query 2-class head and span MLP, plus a
linear saliency head over the encoder's video memory. The DETR layers use
residual dropout (not droppath) and ReLU FFNs. Module names follow the
upstream state dict, so a released Moment-DETR checkpoint loads with
``load_state_dict``.

As in the JAX package, Moment-DETR runs f32 on the plain "xla" attention
whatever ``attention_impl`` and ``compute_dtype`` say: it launches no flash
kernel.

Also here: the Hungarian matching of queries to ground-truth windows
(``hungarian_match``: exhaustive on the device, or scipy on the host) and the
matched losses (``moment_detr_losses``).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from univtg_tpu_torch.core.spans import cxw_to_xx, giou_cross, giou_paired
from univtg_tpu_torch.device import resolve_device
from univtg_tpu_torch.models.config import ModelConfig
from univtg_tpu_torch.models.layers import MLP, InputProj, LayerNorm, Linear, dropout
from univtg_tpu_torch.models.positional import TrainableTextPos, sine_position_from_mask
from univtg_tpu_torch.ops.attention import multihead_attention


@dataclasses.dataclass(frozen=True)
class MomentDETRConfig(ModelConfig):
    num_queries: int = 10
    num_decoder_layers: int = 2
    aux_loss: bool = True
    contrastive_align: bool = False
    contrastive_hdim: int = 64


class Attention(nn.Module):
    """Multi-head attention with torch MHA's parameter names
    (``in_proj_weight`` (3D, D), ``in_proj_bias``, ``out_proj``), always on
    the plain "xla" path; attention dropout draws from the generator."""

    def __init__(self, dim: int, num_heads: int, rate: float):
        super().__init__()
        self.num_heads = num_heads
        self.rate = rate
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Linear(dim, dim)

    def forward(self, q, k, v, key_padding_mask, generator=None):
        return multihead_attention(
            q, k, v, in_proj_weight=self.in_proj_weight,
            in_proj_bias=self.in_proj_bias, out_weight=self.out_proj.weight,
            out_bias=self.out_proj.bias, num_heads=self.num_heads,
            key_padding_mask=key_padding_mask, impl="xla",
            dropout_rate=self.rate, generator=generator)


class DETREncoderLayer(nn.Module):
    """Post-norm: norm1(x + drop(attn(x + pos, x + pos, x))), then
    norm2(x + drop(linear2(drop(relu(linear1(x))))))."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int, rate: float):
        super().__init__()
        self.rate = rate
        self.self_attn = Attention(dim, num_heads, rate)
        self.linear1 = Linear(dim, ffn_dim)
        self.linear2 = Linear(ffn_dim, dim)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, x, mask, pos, generator=None):
        drop = functools.partial(dropout, rate=self.rate, generator=generator)
        qk = x + pos
        x = self.norm1(x + drop(self.self_attn(qk, qk, x, mask, generator)))
        h = self.linear2(drop(F.relu(self.linear1(x))))
        return self.norm2(x + drop(h))


class DETRDecoderLayer(nn.Module):
    """Post-norm: self-attention over the queries (no key mask), then
    cross-attention (query tgt + query_pos, key memory + pos, value memory,
    the memory's mask), then the FFN; upstream calls the cross-attention
    ``multihead_attn``."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int, rate: float):
        super().__init__()
        self.rate = rate
        self.self_attn = Attention(dim, num_heads, rate)
        self.multihead_attn = Attention(dim, num_heads, rate)
        self.linear1 = Linear(dim, ffn_dim)
        self.linear2 = Linear(ffn_dim, dim)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, tgt, memory, memory_mask, pos, query_pos, generator=None):
        g = generator
        drop = functools.partial(dropout, rate=self.rate, generator=g)
        qk = tgt + query_pos
        tgt = self.norm1(tgt + drop(self.self_attn(qk, qk, tgt, None, g)))
        ca = self.multihead_attn(tgt + query_pos, memory + pos, memory, memory_mask, g)
        tgt = self.norm2(tgt + drop(ca))
        h = self.linear2(drop(F.relu(self.linear1(tgt))))
        return self.norm3(tgt + drop(h))


class DETREncoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class DETRDecoder(nn.Module):
    """The layers and the one ``norm`` applied to every layer's output."""

    def __init__(self, layers, dim: int):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = LayerNorm(dim)


class DETRTransformer(nn.Module):
    def __init__(self, encoder: DETREncoder, decoder: DETRDecoder):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder


class MomentDETR(nn.Module):
    def __init__(self, cfg: MomentDETRConfig, *, device="cuda", seed: int = 0):
        """Build the model with weights drawn from ``torch.Generator`` seeded
        with ``seed``. ``device="meta"`` builds the skeleton only."""
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        D = cfg.hidden_dim
        with torch.device("meta"):
            self.input_vid_proj = InputProj(cfg.vid_dim, D, cfg.n_input_proj,
                                            cfg.input_dropout)
            self.input_txt_proj = InputProj(cfg.txt_dim, D, cfg.n_input_proj,
                                            cfg.input_dropout)
            if cfg.use_txt_pos:
                self.txt_position_embed = TrainableTextPos(cfg.max_q_l, D,
                                                           cfg.input_dropout)
            layer = (D, cfg.num_heads, cfg.ffn_dim, cfg.dropout)
            self.transformer = DETRTransformer(
                DETREncoder(DETREncoderLayer(*layer) for _ in range(cfg.num_layers)),
                DETRDecoder((DETRDecoderLayer(*layer)
                             for _ in range(cfg.num_decoder_layers)), D))
            self.query_embed = nn.Embedding(cfg.num_queries, D)
            self.class_embed = Linear(D, 2)
            span_dim = 2 if cfg.span_loss_type == "l1" else cfg.max_v_l * 2
            self.span_embed = MLP(D, D, span_dim, 3)
            self.saliency_proj = Linear(D, 1)
            if cfg.contrastive_align:
                h = cfg.contrastive_hdim
                self.contrastive_align_projection_query = Linear(D, h)
                self.contrastive_align_projection_txt = Linear(D, h)
                self.contrastive_align_projection_vid = Linear(D, h)
        self.eval()
        if dev.type != "meta":
            self.to_empty(device="cpu")
            self.reset_parameters(torch.Generator().manual_seed(seed))
            self.to(dev)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Xavier-uniform matrices, zero biases, unit LayerNorms, N(0, 1)
        queries (JAX's init) and N(0, 0.02) text positions, drawn from
        ``generator`` in module order."""
        init = nn.init
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                init.ones_(m.weight)
                init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                std = 1.0 if m is self.query_embed else 0.02
                init.normal_(m.weight, std=std, generator=generator)
            elif isinstance(m, nn.Linear):
                init.xavier_uniform_(m.weight, generator=generator)
                init.zeros_(m.bias)
            elif isinstance(m, Attention):
                init.xavier_uniform_(m.in_proj_weight, generator=generator)
                init.zeros_(m.in_proj_bias)

    def forward(self, src_txt, src_txt_mask, src_vid, src_vid_mask, *, train=None,
                generator=None):
        """``train`` (default ``self.training``) turns the dropouts on; they
        draw from ``generator``, which training then requires unless every
        rate is 0."""
        if train is None:
            train = self.training
        cfg = self.cfg
        if not train:
            generator = None
        elif generator is None and max(cfg.dropout, cfg.input_dropout) > 0:
            raise ValueError(
                "train=True draws dropout masks: pass generator= (the train "
                "step's torch.Generator), or set every dropout rate to 0")
        g = generator
        f32 = torch.float32
        vid = self.input_vid_proj(src_vid.to(f32), g)
        txt = self.input_txt_proj(src_txt.to(f32), g)
        src = torch.cat([vid, txt], dim=1)
        mask = torch.cat([src_vid_mask, src_txt_mask], dim=1).to(f32)
        pos_vid = sine_position_from_mask(src_vid_mask, cfg.hidden_dim)
        pos_txt = (self.txt_position_embed(txt, g) if cfg.use_txt_pos
                   else torch.zeros_like(txt))
        pos = torch.cat([pos_vid, pos_txt], dim=1)

        memory = src
        for layer in self.transformer.encoder.layers:
            memory = layer(memory, mask, pos, g)

        decoder = self.transformer.decoder
        query_pos = self.query_embed.weight[None].expand(src.shape[0], -1, -1)
        tgt = torch.zeros_like(query_pos)
        hs = []
        for layer in decoder.layers:
            # the next layer takes the un-normed tgt; hs holds the normed one
            tgt = layer(tgt, memory, mask, pos, query_pos, g)
            hs.append(decoder.norm(tgt))
        hs = torch.stack(hs)  # (layers, B, Q, D)

        outputs_class = self.class_embed(hs)
        outputs_coord = self.span_embed(hs)
        if cfg.span_loss_type == "l1":
            outputs_coord = torch.sigmoid(outputs_coord)
        Lv = vid.shape[1]
        vid_mem = memory[:, :Lv]
        out = {
            "pred_logits": outputs_class[-1],  # (B, Q, 2) raw logits
            "pred_spans": outputs_coord[-1],  # (B, Q, 2) cxw, or (B, Q, 2 max_v_l)
            "saliency_scores": self.saliency_proj(vid_mem)[..., 0],
        }
        if cfg.contrastive_align:
            def nrm(x):
                return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)

            out["proj_queries"] = nrm(self.contrastive_align_projection_query(hs))[-1]
            out["proj_txt_mem"] = nrm(self.contrastive_align_projection_txt(memory[:, Lv:]))
            out["proj_vid_mem"] = nrm(self.contrastive_align_projection_vid(vid_mem))
        if cfg.aux_loss:
            out["aux_outputs"] = [
                {"pred_logits": a, "pred_spans": b}
                for a, b in zip(outputs_class[:-1], outputs_coord[:-1])
            ]
        return out


# ---------------------------------------------------------------------------
# Hungarian matching and the matched losses
# ---------------------------------------------------------------------------

# the largest permutation table that impl="auto" enumerates on the device
EXHAUSTIVE_MAX_PERMS = 200_000


def _lsap_host(cost: np.ndarray, n_tgt: np.ndarray) -> np.ndarray:
    """Batched LSAP on the host (scipy). cost (B, Q, Wmax); n_tgt (B,) valid
    targets. Returns (B, Wmax) int32: the query assigned to each target (-1
    where padded)."""
    from scipy.optimize import linear_sum_assignment

    B, Q, W = cost.shape
    out = np.full((B, W), -1, np.int32)
    for b in range(B):
        n = int(n_tgt[b])
        if n == 0:
            continue
        rows, cols = linear_sum_assignment(cost[b, :, :n])
        out[b, cols] = rows
    return out


@functools.lru_cache(maxsize=8)
def _perm_table(num_queries: int, num_targets: int, device: torch.device) -> torch.Tensor:
    """Every injective target -> query map, in itertools.permutations order:
    (P(Q, W), W) int64 on ``device``."""
    perms = np.asarray(list(itertools.permutations(range(num_queries), num_targets)),
                       np.int64).reshape(-1, num_targets)
    return torch.from_numpy(perms).to(device)


def _match_exhaustive(cost, n_windows):
    """Exact min-cost assignment by enumerating all P(Q, W) injective maps
    on the device, no host sync. Padded target columns cost zero, so they
    absorb leftover queries without moving the optimum; argmin takes the
    first minimum."""
    B, Q, W = cost.shape
    perms = _perm_table(Q, W, cost.device)
    cols = torch.arange(W, device=cost.device)
    valid = cols[None, :] < n_windows[:, None]
    cost = cost * valid[:, None, :].to(cost.dtype)
    # total[b, p] = sum_j cost[b, perms[p, j], j]
    best = cost[:, perms, cols].sum(-1).argmin(dim=1)
    return torch.where(valid, perms[best], -1).to(torch.int32)


@torch.no_grad()
def match_cost(outputs, span_labels, cost_span=10.0, cost_giou=1.0, cost_class=4.0,
               span_loss_type: str = "l1"):
    """The (B, Q, Wmax) matching cost, without gradient: -cost_class times
    the foreground probability, plus cost_span times the span L1 and
    cost_giou times -GIoU ('l1'), or cost_span times -(p_st[target st] +
    p_ed[target ed]) ('ce'). Arguments as ``hungarian_match``'s."""
    prob = torch.softmax(outputs["pred_logits"], dim=-1)[..., 0]
    cost_cls = -prob[:, :, None]  # (B, Q, 1), broadcast over targets
    spans = outputs["pred_spans"]
    if span_loss_type == "ce":
        B, Q, two_l = spans.shape
        sp = torch.softmax(spans.reshape(B, Q, 2, two_l // 2), dim=-1)
        idx = span_labels.long()  # (B, Wmax, 2)
        W = idx.shape[1]
        p_st = torch.gather(sp[:, :, 0], 2, idx[:, None, :, 0].expand(B, Q, W))
        p_ed = torch.gather(sp[:, :, 1], 2, idx[:, None, :, 1].expand(B, Q, W))
        return cost_span * (-p_st - p_ed) + cost_class * cost_cls
    l1 = (spans[:, :, None, :] - span_labels[:, None, :, :]).abs().sum(-1)
    giou = giou_cross(cxw_to_xx(spans), cxw_to_xx(span_labels))
    return cost_span * l1 + cost_giou * (-giou) + cost_class * cost_cls


def hungarian_match(outputs, span_labels, n_windows, cost_span=10.0, cost_giou=1.0,
                    cost_class=4.0, impl: str = "auto", span_loss_type: str = "l1"):
    """Per-item bipartite matching of queries to windows.

    outputs: pred_logits (B, Q, 2) raw; pred_spans (B, Q, 2) cxw for 'l1' or
    (B, Q, 2 L) st/ed logits for 'ce'. span_labels: (B, Wmax, 2), cxw floats
    ('l1') or inclusive (st, ed) clip indices ('ce'), zero-padded.
    n_windows: (B,) valid window counts. impl: 'exhaustive' (on the device),
    'callback' (scipy on the host) or 'auto' (exhaustive when P(Q, Wmax) <=
    EXHAUSTIVE_MAX_PERMS). Returns (B, Wmax) int32: the query matched to
    each window, -1 where padded. The cost (``match_cost``) carries no
    gradient.
    """
    cost = match_cost(outputs, span_labels, cost_span, cost_giou, cost_class,
                      span_loss_type)
    B, Q, W = cost.shape
    if impl == "auto":
        impl = "exhaustive" if math.perm(Q, W) <= EXHAUSTIVE_MAX_PERMS else "callback"
    if impl == "exhaustive":
        return _match_exhaustive(cost, n_windows)
    if impl == "callback":
        assign = _lsap_host(cost.float().cpu().numpy(), n_windows.cpu().numpy())
        return torch.from_numpy(assign).to(cost.device)
    raise ValueError(f"unknown matcher impl {impl!r}")


def _matched_map(assign, w_valid, Q):
    """(B, Q) 1.0 at every query matched to a valid window: a scatter-max,
    so that repeated indices never overwrite a 1 with a 0."""
    valid_assign = torch.where(w_valid > 0, assign, -1).long()
    src = (valid_assign >= 0).to(w_valid.dtype)
    return torch.zeros(assign.shape[0], Q, dtype=w_valid.dtype,
                       device=assign.device).scatter_reduce(
        1, valid_assign.clamp_min(0), src, reduce="amax")


def contrastive_align_loss(outputs, assign, w_valid, temperature=0.07):
    """Matched-query vs text-token InfoNCE. outputs: proj_queries (B, Q, d),
    proj_txt_mem (B, Lt, d), normalized; assign (B, Wmax), -1 padded;
    w_valid (B, Wmax) float validity."""
    logits = torch.einsum("bqd,btd->bqt", outputs["proj_queries"],
                          outputs["proj_txt_mem"]).sum(2) / temperature  # (B, Q)
    pos_map = _matched_map(assign, w_valid, logits.shape[1])
    pos_term = (logits * pos_map).sum(1)
    num_pos = pos_map.sum(1).clamp_min(1.0)
    neg_term = torch.logsumexp(logits, dim=1)
    return (-pos_term / num_pos + neg_term).mean()


def _gather_queries(t, assign):
    """t (B, Q, C) at the (B, Wmax) assigned queries -> (B, Wmax, C)."""
    idx = assign.clamp_min(0).long()[..., None].expand(-1, -1, t.shape[-1])
    return torch.gather(t, 1, idx)


def moment_detr_losses(outputs, targets, *, eos_coef=0.1, saliency_margin=0.2,
                       temperature=0.07, aux=True, span_loss_type: str = "l1"):
    """DETR-style matched losses: loss_b (span L1 or st/ed CE), loss_g
    (GIoU; 0 for 'ce'), loss_f (per-query foreground CE, unmatched queries
    weighted eos_coef), loss_s_intra (saliency hinge), loss_contrastive_align
    under contrastive_align, and every aux decoder layer's matched terms as
    ``{k}_{i}``.

    targets: span_labels (B, Wmax, 2), cxw floats ('l1') or st/ed clip
    indices ('ce'); n_windows (B,); saliency_pos/neg_labels (B, P).
    """
    span_labels = targets["span_labels"]
    n_windows = targets["n_windows"]
    B, Wmax = span_labels.shape[:2]
    w_valid = (torch.arange(Wmax, device=n_windows.device)[None, :]
               < n_windows[:, None]).to(torch.float32)
    denom = w_valid.sum().clamp_min(1.0)

    def matched_losses(out, with_align=False):
        assign = hungarian_match(out, span_labels, n_windows,
                                 span_loss_type=span_loss_type)
        pred = _gather_queries(out["pred_spans"], assign)  # (B, Wmax, 2 or 2 L)
        if span_loss_type == "ce":
            # start/end classification over clip indices; no GIoU term
            L = pred.shape[-1] // 2
            logp = torch.log_softmax(pred.reshape(B, Wmax, 2, L), dim=-1)
            idx = span_labels.long()[..., None]  # (B, Wmax, 2, 1)
            ce = -torch.gather(logp, -1, idx)[..., 0]  # (B, Wmax, 2)
            loss_b = (ce * w_valid[..., None]).sum() / (denom * 2)
            loss_g = torch.zeros((), device=pred.device)
        else:
            # the reference means over the (matched, 2) coordinate entries
            l1 = (pred - span_labels).abs().sum(-1)
            giou = giou_paired(cxw_to_xx(pred), cxw_to_xx(span_labels))
            loss_b = (l1 * w_valid).sum() / (denom * 2)
            loss_g = ((1.0 - giou) * w_valid).sum() / denom
        # per-query CE: matched queries are foreground (class 0)
        fg = _matched_map(assign, w_valid, out["pred_logits"].shape[1])
        logp = torch.log_softmax(out["pred_logits"], dim=-1)
        ce = -(fg * logp[..., 0] + (1.0 - fg) * logp[..., 1])
        weights = fg + (1.0 - fg) * eos_coef
        ld = {"loss_b": loss_b, "loss_g": loss_g, "loss_f": (ce * weights).mean()}
        if with_align and "proj_queries" in out:
            ld["loss_contrastive_align"] = contrastive_align_loss(
                out, assign, w_valid, temperature)
        return ld

    losses = matched_losses(outputs, with_align=True)

    sal = outputs["saliency_scores"]
    pos_scores = torch.gather(sal, 1, targets["saliency_pos_labels"].long())
    neg_scores = torch.gather(sal, 1, targets["saliency_neg_labels"].long())
    n_pairs = pos_scores.shape[1]
    hinge = saliency_margin + neg_scores - pos_scores
    # jnp.clip's maximum: a tie at 0 splits its gradient in half
    hinge = torch.maximum(hinge, torch.zeros((), dtype=hinge.dtype, device=hinge.device))
    losses["loss_s_intra"] = hinge.sum() / (B * n_pairs) * 2

    if aux and "aux_outputs" in outputs:
        for i, aux_out in enumerate(outputs["aux_outputs"]):
            for k, v in matched_losses(aux_out).items():
                losses[f"{k}_{i}"] = v
    return losses
