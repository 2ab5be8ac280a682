"""CLIP in PyTorch: the ViT or ModifiedResNet image tower and the causal text
transformer; counterpart of ``univtg_tpu/extract/clip/model.py``.

Modules and parameters carry OpenAI's released state-dict names
(``visual.transformer.resblocks.{i}.attn.in_proj_weight``,
``visual.layer1.0.downsample.0.weight``, ``visual.attnpool.q_proj.weight``,
``text_projection``, ``logit_scale``, ...), so a released ``.pt`` loads
with ``load_state_dict`` and no mapper (interop/clip_ckpt.py).

The JAX towers' arithmetic is kept: QuickGELU at 1.702, LayerNorm eps 1e-5,
attention scores and softmax in f32 with a ``-inf`` causal mask (plain
matmuls: the JAX towers use no Pallas kernel, so neither do these), the EOT
row taken at the first argmax of the token ids, batch norm frozen as
``x * inv + (bias - mean * scale * rsqrt(var + 1e-5))``, the anti-aliased
average pool before the strided bottleneck's conv3 and its 1x1 downsample,
and an attention pool that computes its one mean-token query alone.
Weights stay in their own dtype and are cast to ``compute_dtype`` on use,
as flax's ``dtype=`` does, with one exception kept from JAX's type
promotion: the attention's q/k/v and output projections multiply the
compute-dtype activations by the f32 weights, so they run in f32, and the
residual stream is f32 from the first block on. LayerNorms compute in f32
and return the compute dtype, as flax's do. Images come in as (B, H, W, 3),
as in JAX, and are permuted to NCHW once inside.

``encode_text`` returns both ``last_hidden_state`` (every position after
ln_final, what the grounding model reads) and ``pooler_output``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from univtg_tpu_torch.device import exact_f32, resolve_device
from univtg_tpu_torch.models.layers import LN_EPS, Linear


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    # int -> ViT depth; tuple -> ModifiedResNet stage block counts (RN50 =
    # (3, 4, 6, 3))
    vision_layers: object = 12
    vision_width: int = 768
    vision_patch_size: int = 32  # ViT only
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12
    compute_dtype: str = "float32"

    @property
    def is_resnet(self):
        return isinstance(self.vision_layers, (tuple, list))

    @property
    def vision_heads(self):
        if self.is_resnet:  # attnpool heads: width * 32 // 64
            return self.vision_width * 32 // 64
        return self.vision_width // 64

    @property
    def grid(self):
        return self.image_resolution // self.vision_patch_size

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def vit_b32():
    return CLIPConfig()


def vit_b16():
    return CLIPConfig(vision_patch_size=16)


def rn50():
    return CLIPConfig(
        embed_dim=1024,
        vision_layers=(3, 4, 6, 3),
        vision_width=64,
        vision_patch_size=0,
    )


def rn101():
    return CLIPConfig(
        embed_dim=512,
        vision_layers=(3, 4, 23, 3),
        vision_width=64,
        vision_patch_size=0,
    )


def _attend(q, k, v, scale, causal: bool):
    """(B, H, Lq, dh) x (B, H, Lk, dh): scores and softmax in f32, the
    probabilities cast to v's dtype, the product summed in f32 and returned
    in v's dtype (the JAX einsums' preferred_element_type=f32)."""
    scores = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if causal:
        L = scores.shape[-1]
        keep = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)


def _heads(x, H):
    B, L, D = x.shape
    return x.reshape(B, L, H, D // H).transpose(1, 2)


def _promoted_linear(x, weight, bias):
    """``x @ weight.T + bias`` in the promoted dtype of x and the weight, as
    jnp's ``h @ kernel`` is (bf16 activations by f32 weights run in f32)."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    return F.linear(x.to(dt), weight.to(dt), bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm (eps 1e-5) computed in f32 at least with its f32 affine
    terms, and returned in ``dtype`` (default: the input's), as flax's
    ``LayerNorm(dtype=...)`` is."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x, dtype=None):
        ct = torch.promote_types(x.dtype, torch.float32)
        y = F.layer_norm(x.to(ct), self.normalized_shape, self.weight.to(ct),
                         self.bias.to(ct), self.eps)
        return y.to(dtype or x.dtype)


class MultiheadAttention(nn.Module):
    """Self-attention holding nn.MultiheadAttention's parameter names
    (in_proj_weight (3D, D), in_proj_bias, out_proj)."""

    def __init__(self, width: int, heads: int, causal: bool):
        super().__init__()
        self.heads = heads
        self.causal = causal
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, h, out_dtype):
        """h: the LayerNorm's output in the compute dtype. The attention is
        cast to ``out_dtype`` (the residual's) before the output projection,
        as JAX's ``attn.astype(x.dtype)`` is."""
        B, L, D = h.shape
        w, b = self.in_proj_weight, self.in_proj_bias
        q, k, v = (_heads(_promoted_linear(h, w[i * D:(i + 1) * D], b[i * D:(i + 1) * D]),
                          self.heads) for i in range(3))
        dh = D // self.heads
        attn = _attend(q, k, v, dh**-0.5, self.causal).transpose(1, 2).reshape(B, L, D)
        return _promoted_linear(attn.to(out_dtype), self.out_proj.weight, self.out_proj.bias)


class QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, causal: bool):
        super().__init__()
        self.attn = MultiheadAttention(width, heads, causal)
        self.ln_1 = LayerNorm(width)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", Linear(width, 4 * width)),
            ("gelu", QuickGELU()),
            ("c_proj", Linear(4 * width, width)),
        ]))
        self.ln_2 = LayerNorm(width)

    def forward(self, x, dtype):
        """x: the residual stream (the compute dtype before the first block,
        f32 after it); the LayerNorms hand the compute ``dtype`` on."""
        x = x + self.attn(self.ln_1(x, dtype), x.dtype)
        return x + self.mlp(self.ln_2(x, dtype))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, causal: bool):
        super().__init__()
        self.resblocks = nn.Sequential(*[
            ResidualAttentionBlock(width, heads, causal) for _ in range(layers)])

    def forward(self, x, dtype):
        for block in self.resblocks:
            x = block(x, dtype)
        return x


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        w = cfg.vision_width
        self.conv1 = nn.Conv2d(3, w, cfg.vision_patch_size, cfg.vision_patch_size,
                               bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.grid**2 + 1, w))
        self.ln_pre = LayerNorm(w)
        self.transformer = Transformer(w, cfg.vision_layers, cfg.vision_heads,
                                       causal=False)
        self.ln_post = LayerNorm(w)
        self.proj = nn.Parameter(torch.empty(w, cfg.embed_dim))

    def forward(self, x):
        """x: (B, 3, H, W) in the compute dtype -> (B, embed_dim)."""
        x = self.conv1._conv_forward(x, self.conv1.weight.to(x.dtype), None)
        B, C = x.shape[:2]
        x = x.reshape(B, C, -1).transpose(1, 2)  # (B, grid^2, width), row-major
        cls = self.class_embedding.to(x.dtype).expand(B, 1, C)
        dt = x.dtype
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = self.transformer(self.ln_pre(x), dt)
        return self.ln_post(x[:, 0, :], dt) @ self.proj.to(dt)


class FrozenBatchNorm2d(nn.Module):
    """Inference-only batch norm over the running statistics, with
    BatchNorm2d's state-dict names (num_batches_tracked is held and never
    read); eps 1e-5. Training mode changes nothing."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.empty(features))
        self.register_buffer("running_var", torch.empty(features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x):
        r = torch.rsqrt(self.running_var + 1e-5)
        inv = (self.weight * r).to(x.dtype)
        shift = (self.bias - self.running_mean * self.weight * r).to(x.dtype)
        return x * inv[:, None, None] + shift[:, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


def _conv_bn_relu(conv: nn.Conv2d, bn: FrozenBatchNorm2d, x, relu=True):
    x = bn(conv._conv_forward(x, conv.weight.to(x.dtype), None))
    return F.relu(x) if relu else x


class Bottleneck(nn.Module):
    """Anti-aliased bottleneck: every conv has stride 1; a stride-s block
    average-pools after conv2 and before its 1x1 downsample."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.conv1, self.bn1 = _conv(inplanes, planes, 1), FrozenBatchNorm2d(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), FrozenBatchNorm2d(planes)
        self.conv3, self.bn3 = _conv(planes, out, 1), FrozenBatchNorm2d(out)
        self.downsample = None
        if stride > 1 or inplanes != out:
            # "-1" is the released archives' parameterless AvgPool2d
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride) if stride > 1 else nn.Identity()),
                ("0", _conv(inplanes, out, 1)),
                ("1", FrozenBatchNorm2d(out)),
            ]))

    def forward(self, x):
        h = _conv_bn_relu(self.conv1, self.bn1, x)
        h = _conv_bn_relu(self.conv2, self.bn2, h)
        if self.stride > 1:
            h = F.avg_pool2d(h, self.stride)
        h = _conv_bn_relu(self.conv3, self.bn3, h, relu=False)
        identity = x
        if self.downsample is not None:
            pool, conv, bn = self.downsample
            identity = _conv_bn_relu(conv, bn, pool(x), relu=False)
        return F.relu(h + identity)


class AttentionPool2d(nn.Module):
    """QKV attention pooling whose one query is the mean token: only that
    row's output is used, so it is the only row computed."""

    def __init__(self, spacial_dim: int, embed_dim: int, heads: int, output_dim: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(torch.empty(spacial_dim**2 + 1, embed_dim))
        self.k_proj = Linear(embed_dim, embed_dim)
        self.q_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.c_proj = Linear(embed_dim, output_dim)
        self.num_heads = heads

    def forward(self, x):
        """x: (B, C, H, W) -> (B, output_dim)."""
        B, C = x.shape[:2]
        tokens = x.reshape(B, C, -1).transpose(1, 2)  # (B, HW, C), row-major
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(x.dtype)
        H = self.num_heads
        q = _heads(self.q_proj(tokens[:, :1]), H)
        k, v = _heads(self.k_proj(tokens), H), _heads(self.v_proj(tokens), H)
        attn = _attend(q, k, v, (C // H)**-0.5, causal=False)
        return self.c_proj(attn.transpose(1, 2).reshape(B, 1, C))[:, 0]


class ModifiedResNet(nn.Module):
    """CLIP's ResNet tower: a 3-conv stem with an average pool, the
    anti-aliased bottlenecks, attention pooling."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        w = cfg.vision_width
        self.conv1, self.bn1 = _conv(3, w // 2, 3, 2), FrozenBatchNorm2d(w // 2)
        self.conv2, self.bn2 = _conv(w // 2, w // 2, 3), FrozenBatchNorm2d(w // 2)
        self.conv3, self.bn3 = _conv(w // 2, w, 3), FrozenBatchNorm2d(w)
        inplanes = w
        for stage, blocks in enumerate(cfg.vision_layers):
            planes = w * 2**stage
            layer = []
            for i in range(blocks):
                layer.append(Bottleneck(inplanes, planes, 2 if stage > 0 and i == 0 else 1))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
        self.n_stages = len(cfg.vision_layers)
        self.attnpool = AttentionPool2d(cfg.image_resolution // 32, w * 32,
                                        cfg.vision_heads, cfg.embed_dim)

    def forward(self, x):
        for i in (1, 2, 3):
            x = _conv_bn_relu(getattr(self, f"conv{i}"), getattr(self, f"bn{i}"), x)
        x = F.avg_pool2d(x, 2)
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return self.attnpool(x)


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig, *, device="cuda", seed: int = 0):
        """Build CLIP with weights drawn from ``torch.Generator`` seeded with
        ``seed``. ``device="meta"`` builds the skeleton only, for
        ``load_state_dict(..., assign=True)``."""
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        tw = cfg.transformer_width
        with torch.device("meta"):
            self.visual = (ModifiedResNet if cfg.is_resnet else VisionTransformer)(cfg)
            self.transformer = Transformer(tw, cfg.transformer_layers,
                                           cfg.transformer_heads, causal=True)
            self.token_embedding = nn.Embedding(cfg.vocab_size, tw)
            self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, tw))
            self.ln_final = LayerNorm(tw)
            self.text_projection = nn.Parameter(torch.empty(tw, cfg.embed_dim))
            self.logit_scale = nn.Parameter(torch.empty(()))
        self.eval()
        if dev.type != "meta":
            self.to_empty(device="cpu")
            self.reset_parameters(torch.Generator().manual_seed(seed))
            self.to(dev)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """OpenAI's initialisation scales (normal draws from ``generator`` in
        module order); unit batch-norm statistics."""
        g = generator
        normal = nn.init.normal_
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, FrozenBatchNorm2d):
                for t, fill in ((m.weight, 1), (m.bias, 0), (m.running_mean, 0),
                                (m.running_var, 1), (m.num_batches_tracked, 0)):
                    t.fill_(fill)
            elif isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, generator=g)
            elif isinstance(m, (nn.Linear, MultiheadAttention)):
                w = m.weight if isinstance(m, nn.Linear) else m.in_proj_weight
                b = m.bias if isinstance(m, nn.Linear) else m.in_proj_bias
                normal(w, std=w.shape[1] ** -0.5, generator=g)
                nn.init.zeros_(b)
            elif isinstance(m, nn.Embedding):
                normal(m.weight, std=0.02, generator=g)
        cfg = self.cfg
        v = self.visual
        if cfg.is_resnet:
            normal(v.attnpool.positional_embedding, std=(cfg.vision_width * 32) ** -0.5,
                   generator=g)
        else:
            scale = cfg.vision_width ** -0.5
            for p in (v.class_embedding, v.positional_embedding, v.proj):
                normal(p, std=scale, generator=g)
        normal(self.positional_embedding, std=0.01, generator=g)
        normal(self.text_projection, std=cfg.transformer_width ** -0.5, generator=g)
        self.logit_scale.fill_(torch.log(torch.tensor(1 / 0.07)).item())

    def encode_image(self, images):
        """images: (B, H, W, 3) normalized pixels -> (B, embed_dim)."""
        x = images.to(self.cfg.dtype).permute(0, 3, 1, 2)
        with exact_f32(self.cfg.dtype):  # the patch or ResNet convs in f32
            return self.visual(x)

    def encode_text(self, tokens):
        """tokens: (B, L) integer ids -> {last_hidden_state (B, L, width),
        pooler_output (B, embed_dim)}; the pooled row is the first argmax of
        each row's ids (EOT, the largest id)."""
        dt = self.cfg.dtype
        L = tokens.shape[1]
        x = self.token_embedding.weight.to(dt)[tokens.long()]
        x = x + self.positional_embedding[:L].to(dt)
        x = self.ln_final(self.transformer(x, dt), dt)
        eot = tokens.argmax(dim=-1)  # the first maximum, as jnp.argmax
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return {"last_hidden_state": x,
                "pooler_output": pooled @ self.text_projection.to(dt)}

    def forward(self, images, tokens):
        img = self.encode_image(images)
        txt = self.encode_text(tokens)["pooler_output"]
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        return self.logit_scale.exp() * img @ txt.T

