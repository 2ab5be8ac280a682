"""UniVTG flagship model: unified video-language temporal grounding.

Counterpart of ``univtg_tpu/models/univtg.py``. One encoder, three heads
over the video half of the memory:

  * foreground head -- per-clip grounding probability (sigmoid),
  * boundary head   -- per-clip (left, right) offsets in (-1, 0) x (0, 1),
  * saliency head   -- cosine similarity between the projected video tokens
    and the weighted-pooled sentence vector: a skip connection from the
    PRE-encoder video tokens, not from the encoder memory.

The forward is ``pre`` (input projections, token types, positions) ->
``encoder`` -> ``heads``. Module names follow the upstream state dict, so a
released checkpoint's ``model`` entry loads with ``load_state_dict``.

One switch, ``train=``, as in the JAX package (it defaults to
``self.training``). In training, input dropout, attention dropout and
droppath draw from the ``generator`` the caller passes (the train step
seeds one per step); eval needs none.
"""
from __future__ import annotations

import torch
from torch import nn

from univtg_tpu_torch.device import exact_f32, resolve_device
from univtg_tpu_torch.models.config import ModelConfig, check_supported
from univtg_tpu_torch.models.encoder import Encoder, SelfAttention, Transformer
from univtg_tpu_torch.models.layers import (
    ConvHead,
    InputProj,
    WeightedPool,
    cosine_similarity,
    mask_log,
)
from univtg_tpu_torch.models.positional import (
    TrainableTextPos,
    sine_position_from_mask,
)

class UniVTG(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0):
        """Build the model with weights drawn from ``torch.Generator`` seeded
        with ``seed``. ``device="meta"`` builds the skeleton only, for
        ``load_state_dict(..., assign=True)``."""
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        D = cfg.hidden_dim
        with torch.device("meta"):
            self.input_vid_proj = InputProj(
                cfg.vid_dim, D, cfg.n_input_proj, cfg.input_dropout
            )
            self.input_txt_proj = InputProj(
                cfg.txt_dim, D, cfg.n_input_proj, cfg.input_dropout
            )
            self.token_type_embeddings = nn.Embedding(2, D)
            if cfg.use_txt_pos:
                self.txt_position_embed = TrainableTextPos(
                    cfg.max_q_l, D, cfg.input_dropout
                )
            self.transformer = Transformer(Encoder(
                D, cfg.num_layers, cfg.num_heads, cfg.ffn_dim, cfg.dropout,
                cfg.droppath, cfg.pre_norm, cfg.attention_impl,
            ))
            span_pred_dim = 2 if cfg.span_loss_type == "l1" else cfg.max_v_l * 2
            self.class_embed = ConvHead(D, 1, 3)
            self.span_embed = ConvHead(D, span_pred_dim, 3)
            self.weightedpool = WeightedPool(D)
        self.eval()
        if dev.type != "meta":
            self.to_empty(device="cpu")
            self.reset_parameters(torch.Generator().manual_seed(seed))
            self.to(dev)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Xavier-uniform matrices, zero biases, unit LayerNorms, N(0, 0.02)
        embeddings, all drawn from ``generator`` in module order."""
        init = nn.init
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                init.ones_(m.weight)
                init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                init.normal_(m.weight, std=0.02, generator=generator)
            elif isinstance(m, (nn.Linear, nn.Conv1d)):
                init.xavier_uniform_(m.weight, generator=generator)
                init.zeros_(m.bias)
            elif isinstance(m, SelfAttention):
                init.xavier_uniform_(m.in_proj_weight, generator=generator)
                init.zeros_(m.in_proj_bias)
            elif isinstance(m, WeightedPool):
                init.xavier_uniform_(m.weight, generator=generator)

    def pre(self, src_txt, src_txt_mask, src_vid, src_vid_mask, src_cls=None,
            src_cls_mask=None, generator=None):
        """Project both modalities, add token types ([1] video, [0] text)
        and build the [vid; txt] encoder input, mask and positions.

        Returns (src, mask, pos, vid, txt, cls_tok)."""
        cfg = self.cfg
        dt = cfg.dtype
        g = generator
        token_type = self.token_type_embeddings.weight.to(dt)
        vid = self.input_vid_proj(src_vid.to(dt), g) + token_type[1]
        txt = self.input_txt_proj(src_txt.to(dt), g) + token_type[0]
        cls_tok = None
        if src_cls is not None:
            cls_tok = self.input_txt_proj(src_cls.to(dt), g) + token_type[0]

        src = torch.cat([vid, txt], dim=1)
        mask = torch.cat([src_vid_mask, src_txt_mask], dim=1).to(dt)
        pos_vid = sine_position_from_mask(src_vid_mask, cfg.hidden_dim,
                                          dtype=dt)
        if cfg.use_txt_pos:
            pos_txt = self.txt_position_embed(txt, g)
        else:
            pos_txt = torch.zeros_like(txt)
        pos = torch.cat([pos_vid, pos_txt], dim=1)
        return src, mask, pos, vid, txt, cls_tok

    def encoder(self, src, mask, pos, generator=None):
        return self.transformer.encoder(src, mask, pos, generator)

    def heads(self, memory, vid, txt, src_vid_mask, src_txt_mask, cls_tok=None,
              src_cls_mask=None):
        """Conv heads over the memory's video half (masked after every conv)
        and the saliency skip connection from the pre-encoder tokens."""
        cfg = self.cfg
        dt = cfg.dtype
        vid_mem = memory[:, : vid.shape[1], :]
        vmask = src_vid_mask.to(dt)

        pred_logits = torch.sigmoid(self.class_embed(vid_mem, vmask))
        raw_spans = self.span_embed(vid_mem, vmask)
        if cfg.span_loss_type == "l1":
            # (-sigmoid, +sigmoid): left offsets negative, right positive
            # (no host tensor: a CUDA graph cannot capture its copy)
            spans = torch.sigmoid(raw_spans)
            pred_spans = torch.cat([-spans[..., :1], spans[..., 1:]], dim=-1)
        else:
            pred_spans = raw_spans  # (B, Lv, 2*max_v_l) start/end logits

        txt_pooled = self.weightedpool(txt, src_txt_mask.to(dt))
        txt_mem_proj = txt_pooled[:, None, :]  # (B, 1, D)
        saliency = cosine_similarity(vid, txt_mem_proj) + mask_log(
            src_vid_mask.to(torch.float32)
        )
        out = {
            "pred_logits": pred_logits,
            "pred_spans": pred_spans,
            "src_vid_mask": src_vid_mask,
            "vid_mem_proj": vid,
            "txt_mem_proj": txt_mem_proj,
            "saliency_scores": saliency,
        }
        if cls_tok is not None:
            out["cls_mem_proj"] = self.weightedpool(cls_tok,
                                                    src_cls_mask.to(dt))
        return out

    def forward(self, src_txt, src_txt_mask, src_vid, src_vid_mask,
                src_cls=None, src_cls_mask=None, *, train=None,
                generator=None):
        """``train`` (default ``self.training``) turns dropout and droppath
        on; they draw from ``generator``, which training then requires
        unless every rate is 0. Eval ignores the generator."""
        if train is None:
            train = self.training
        cfg = self.cfg
        if not train:
            generator = None
        elif generator is None and max(cfg.dropout, cfg.droppath,
                                       cfg.input_dropout) > 0:
            raise ValueError(
                "train=True draws dropout masks: pass generator= (the train "
                "step's torch.Generator), or set every dropout rate to 0"
            )
        with exact_f32(cfg.dtype):  # the conv heads in f32, not TF32
            src, mask, pos, vid, txt, cls_tok = self.pre(
                src_txt, src_txt_mask, src_vid, src_vid_mask, src_cls,
                src_cls_mask, generator,
            )
            memory = self.encoder(src, mask, pos, generator)
            return self.heads(memory, vid, txt, src_vid_mask, src_txt_mask,
                              cls_tok, src_cls_mask)
