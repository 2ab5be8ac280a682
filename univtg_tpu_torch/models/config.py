"""Typed model configuration: the same fields, defaults and JSON as
``univtg_tpu/models/config.py``, so one config file drives both packages.

``check_supported`` names the values a model built from this config cannot
run.
"""
from __future__ import annotations

import dataclasses
import json

import torch

ATTENTION_IMPLS = ("xla", "pallas", "ring", "ring_pallas")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # input feature dims (after TEF concat if used)
    vid_dim: int = 2818  # slowfast 2304 + clip 512 + tef 2
    txt_dim: int = 512
    hidden_dim: int = 1024
    # encoder
    num_layers: int = 4
    num_heads: int = 8
    ffn_dim: int = 1024
    dropout: float = 0.0
    droppath: float = 0.1
    input_dropout: float = 0.5
    pre_norm: bool = False
    # input projectors (LN -> dropout -> dense [-> relu]) stacks
    n_input_proj: int = 2
    # heads
    span_loss_type: str = "l1"  # "l1" (offset regression) | "ce" (start/end cls)
    max_v_l: int = 75
    use_txt_pos: bool = False
    max_q_l: int = 32
    # numerics: params keep their own dtype; activations run in compute_dtype
    compute_dtype: str = "float32"
    # attention implementation:
    #   "xla"         plain-torch attention (the counterpart of sdpa_xla)
    #   "pallas"      the hand-written CUDA flash kernels on a CUDA tensor
    #                 (ops/flash_attention.py), their plain twins on a CPU one
    #   "ring"        context-parallel attention over the ring made active by
    #                 parallel.use_ring: the plain ring (ops/ring_attention.py)
    #   "ring_pallas" the same on the hand-written CUDA ring kernels
    #                 (ops/ring_attention_pallas.py; their twin on a CPU
    #                 tensor), the backward through the plain ring
    #   Both ring impls run "xla" when no ring is active or the sequence does
    #   not tile over it; "ring_pallas" runs "ring" under attention dropout.
    attention_impl: str = "xla"
    # shard the token axis of the activations between the encoder's matrices
    # over tp (Megatron sequence parallelism; parallel/mesh.py), where L
    # tiles over it; a no-op without a mesh with tp > 1
    seq_shard: bool = False
    # recompute each encoder layer in the backward (torch.utils.checkpoint)
    remat: bool = False
    # the JAX package runs the layers as one lax.scan over stacked params;
    # here it changes only the layout read from a JAX tree (interop)
    scan_layers: bool = False
    # pipeline parallelism over the encoder layers (parallel/pipeline.py):
    # pipeline_stages > 1 runs the layers as a pipeline over the pp axis of
    # the mesh the model is put on (parallel/mesh.shard_model), with
    # pipeline_microbatches microbatches (0: pipeline_stages) and
    # pipeline_interleave chunks a stage; needs scan_layers (as in JAX).
    # Off such a mesh it warns once and runs the layers in order.
    # pipeline_pre_permuted: JAX's device-major layout flag; the port keeps
    # a stage's layers under their canonical indices, and refuses the flag
    # (with interleave > 1) off the pipeline, as JAX does
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0
    pipeline_interleave: int = 1
    pipeline_pre_permuted: bool = False
    # Mixture-of-Experts FFN (ops/moe.py): moe_experts > 1 puts a top-k
    # routed bank of moe_experts experts in each layer's FFN; its
    # load-balance loss reaches the objective through LossWeights.moe_aux
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25

    @property
    def dtype(self) -> torch.dtype:
        dt = getattr(torch, self.compute_dtype, None)
        if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        return dt

    @property
    def head_dim(self) -> int:
        assert self.hidden_dim % self.num_heads == 0
        return self.hidden_dim // self.num_heads

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)

    @classmethod
    def from_json(cls, s: str) -> "ModelConfig":
        return cls(**json.loads(s))


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the config values the port cannot run."""
    if cfg.pipeline_stages > 1 and not cfg.scan_layers:
        raise ValueError(
            "pipeline_stages needs scan_layers=True (the pipeline "
            "shards the stacked scan parameter layout over pp)")
    if cfg.moe_experts > 1 and cfg.moe_top_k > cfg.moe_experts:
        raise ValueError(f"moe_top_k={cfg.moe_top_k} must be <= "
                         f"moe_experts={cfg.moe_experts}")
    if cfg.attention_impl not in ATTENTION_IMPLS:
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r}: the PyTorch port runs "
            f"{ATTENTION_IMPLS} (ROADMAP.md)"
        )
