"""OpenAI CLIP checkpoints into the port; counterpart of
``univtg_tpu/interop/clip_ckpt.py``.

The port's CLIP (extract/clip/model.py) keeps the released state-dict names,
so a checkpoint needs no param converter: ``config_from_state_dict`` reads
the architecture (ViT or ModifiedResNet) off the tensors' shapes and
``load_clip_checkpoint`` returns the state_dict as it is, floats widened to
f32.
"""
from __future__ import annotations

import torch

from univtg_tpu_torch.extract.clip.model import CLIP, CLIPConfig

# integer entries of the released TorchScript archives that are not
# parameters (OpenAI's build_model deletes them too)
ARCHIVE_INTS = ("input_resolution", "context_length", "vocab_size")


def _count(sd, prefix: str, part: int) -> int:
    return len({k.split(".")[part] for k in sd if k.startswith(prefix)})


def config_from_state_dict(sd) -> CLIPConfig:
    """Infer the architecture (ViT or ModifiedResNet) from a released
    state_dict."""
    text = dict(
        embed_dim=sd["text_projection"].shape[1],
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=sd["ln_final.weight"].shape[0],
        transformer_heads=sd["ln_final.weight"].shape[0] // 64,
        transformer_layers=_count(sd, "transformer.resblocks", 2),
    )
    if "visual.layer1.0.conv1.weight" in sd:  # ResNet releases (RN50/RN101/...)
        counts = tuple(_count(sd, f"visual.layer{stage}.", 2) for stage in (1, 2, 3, 4))
        out_grid = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        return CLIPConfig(
            image_resolution=out_grid * 32,
            vision_layers=counts,
            vision_width=sd["visual.conv1.weight"].shape[0] * 2,  # stem conv1 = w//2
            vision_patch_size=0,
            **text,
        )
    patch = sd["visual.conv1.weight"].shape[-1]
    grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    return CLIPConfig(
        image_resolution=grid * patch,
        vision_layers=_count(sd, "visual.transformer.resblocks", 3),
        vision_width=sd["visual.conv1.weight"].shape[0],
        vision_patch_size=patch,
        **text,
    )


def _read(path):
    """A TorchScript archive (OpenAI's releases) through torch.jit.load, else
    a plain state_dict file through torch.load with weights_only=True."""
    try:
        return torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        return torch.load(path, map_location="cpu", weights_only=True)


def load_clip_checkpoint(path):
    """A released CLIP ``.pt`` (TorchScript archive or plain state_dict) ->
    (state_dict, CLIPConfig). The archives' integer entries are dropped, the
    floats widened to f32 (the releases hold fp16), and the keys checked
    against CLIP(cfg) by a strict load_state_dict."""
    sd = {k: v for k, v in _read(path).items() if k not in ARCHIVE_INTS}
    sd = {k: v.float() if v.is_floating_point() else v for k, v in sd.items()}
    cfg = config_from_state_dict(sd)
    CLIP(cfg, device="meta").load_state_dict(sd, strict=True, assign=True)
    return sd, cfg
