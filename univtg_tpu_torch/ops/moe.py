"""Mixture-of-Experts FFN with capacity-based top-k routing; counterpart of
``univtg_tpu/ops/moe.py`` (``moe_capacity``, ``moe_routing``, ``moe_ffn``).

The semantics are the JAX package's (GShard/Switch):

  * the router's softmax in f32 over ``x.float() @ router.float()``, the
    probabilities masked by the token mask (padding routes nowhere, takes
    no capacity and leaves the aux alone);
  * top-k by repeated argmax (the first maximal index, as ``jnp.argmax``);
    top-1 keeps the raw probability as its gate, so the router gets the
    task gradient; top-k >= 2 renormalises the gates over the chosen set;
  * each expert takes C = ``moe_capacity`` tokens; slot-k tokens queue
    behind the kept slot-(k-1) tokens, in token order; a token past C is
    dropped from that expert (the residual carries it);
  * the load-balance aux E * sum_e f_e * p_e over the routed tokens, f from
    the top-1 choice: 1.0 at perfect balance.

JAX dispatches through one-hot (N, E, C) tensors and four einsums. Here the
kept tokens are gathered into an (E, C, D) buffer by their (expert, slot),
the experts run as one ``torch.bmm`` pair over the stacked (E, D, F) /
(E, F, D) weights, and each token's output is the gate-weighted sum of its
k rows, gathered back. Shapes are static and nothing reads the device from
the host, so a train step with it captures in a CUDA graph. A dropped token
goes to a spare row past the E * C slots, which is never read.
``moe_ffn_reference`` is the JAX einsum version line for line, for the
tests.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from univtg_tpu_torch.parallel import mesh as pm


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Per-expert token capacity: ceil(top_k * N * factor / E), rounded up
    to a multiple of 8 and capped at N. The multiple of 8 is a TPU tile in
    the JAX package; it decides which tokens are dropped, so it stays."""
    c = math.ceil(top_k * n_tokens * capacity_factor / n_experts)
    c = ((c + 7) // 8) * 8
    return min(n_tokens, c)


class Routing(NamedTuple):
    """Each token's k assignments, slot-major: (k, N) tensors."""

    expert: torch.Tensor  # chosen expert (long)
    slot: torch.Tensor    # position in that expert's buffer (long)
    keep: torch.Tensor    # 1.0 = routed within capacity (f32)
    gate: torch.Tensor    # combine weight (f32; 0 where not kept)
    aux: Optional[torch.Tensor]  # load-balance loss, or None


def _check_top_k(top_k: int, n_experts: int):
    if top_k > n_experts:
        raise ValueError(
            f"moe_routing: top_k={top_k} > n_experts={n_experts}: the extra "
            "choices would re-select expert 0 with a zero gate")


def _choices(probs, n_experts: int, top_k: int):
    """The k (expert, raw gate) pairs by repeated argmax; gates
    renormalised over the chosen set for k >= 2."""
    remaining = probs
    experts = torch.arange(n_experts, device=probs.device)
    choices, gates = [], []
    for _ in range(top_k):
        e_k = torch.argmax(remaining, dim=-1)
        onehot = (e_k[:, None] == experts).to(torch.float32)
        gates.append(torch.sum(remaining * onehot, dim=-1))
        choices.append((e_k, onehot))
        remaining = remaining * (1.0 - onehot)
    if top_k > 1:
        gate_sum = sum(gates)
        denom = torch.where(gate_sum > 0, gate_sum, torch.ones_like(gate_sum))
        gates = [g / denom for g in gates]
    return choices, gates


def _aux(onehot0, probs, mask, n_experts: int):
    n_routed = torch.clamp_min(torch.sum(mask), 1.0)
    f = torch.sum(onehot0 * mask[:, None], dim=0) / n_routed
    p = torch.sum(probs, dim=0) / n_routed
    return n_experts * torch.sum(f * p)


def moe_routing(probs, n_experts: int, top_k: int, capacity: int,
                token_mask=None, aux: bool = True) -> Routing:
    """Capacity-based top-k assignment of (N, E) f32 router probabilities.

    token_mask: optional (N,) float, 1 = route this token, 0 = padding.
    Returns the Routing; its ``aux`` is None unless ``aux``."""
    _check_top_k(top_k, n_experts)
    n = probs.shape[0]
    mask = (torch.ones(n, device=probs.device) if token_mask is None
            else token_mask.to(torch.float32))
    probs = probs * mask[:, None]
    choices, gates = _choices(probs, n_experts, top_k)

    counts = torch.zeros(n_experts, device=probs.device)
    expert, slot, keep, gate = [], [], [], []
    for (e_k, onehot), g in zip(choices, gates):
        onehot = onehot * mask[:, None]
        # the running count over the tokens, scanned along the last axis of
        # (E, N): a scan down the N axis of (N, E) leaves the card E threads
        running = torch.cumsum(onehot.t().contiguous(), dim=1).t()
        pos_in_e = counts[None, :] + running - onehot
        pos = torch.sum(pos_in_e * onehot, dim=-1)
        kept = (pos < capacity).to(torch.float32) * mask
        counts = counts + torch.sum(onehot * kept[:, None], dim=0)
        expert.append(e_k)
        slot.append(pos.long())
        keep.append(kept)
        gate.append(g * kept)
    loss = _aux(choices[0][1], probs, mask, n_experts) if aux else None
    return Routing(torch.stack(expert), torch.stack(slot), torch.stack(keep),
                   torch.stack(gate), loss)


def moe_ffn(x, router, w1, b1, w2, b2, *, top_k: int = 1,
            capacity_factor: float = 1.25, token_mask=None, aux: bool = True,
            mesh=None, seq: bool = False):
    """Sparsely-activated exact-GELU FFN: (B, L, D) -> ((B, L, D), aux).

    router: (D, E); w1, b1: (E, D, F), (E, F); w2, b2: (E, F, D), (E, D),
    in x's dtype (the router is taken in f32). token_mask: optional (B, L)
    float, 1 = valid token. The aux is None unless ``aux``.

    On a ``mesh`` (parallel/mesh.py; None: one process) it is JAX's
    global-batch routing and its ep and tp sharding of the bank. x holds
    this rank's tokens (B, L, D), or under ``seq`` its (B, L/tp, D) token
    block; w1, b1, w2, b2 this rank's E/ep experts, each with F/tp columns;
    the router is whole.

      * routing: the router runs on every token of the dp row (under seq
        the blocks all-gathered, each rank's gradient kept to its block);
        in training (``aux``) the (N, E) f32 probabilities and the token
        mask are all-gathered over dp, this rank's rows live, and the global
        batch is routed on every rank: C from the global N, the slots in
        the global token order (rank-major), the aux over every token. This
        rank keeps its rows of (expert, slot, keep, gate). Only
        probabilities cross the wire: each token's expert output is
        computed where the token is. On a pp mesh (parallel/pipeline.py)
        each (microbatch x dp shard) block routes alone, as JAX's pipelines
        route: C from the block's N, the aux over its tokens;
      * experts: each rank fills and runs only its E/ep experts' (E/ep, C,
        D) buffer over its F/tp columns; b2 is added once per token (on tp
        rank 0, its gradient all-reduced over tp);
      * combine: the gate-weighted rows, partial over ep and tp, are summed
        over the dp row (under seq: all-reduced over ep, reduce-scattered
        back into token blocks over tp). The gradients that flow back into
        x and into the gates from the local experts are partial, and are
        all-reduced over the dp row (``copy_to``), so the router trains on
        its whole gradient.

    Returns ((B, L or L/tp, D) in x's dtype, aux or None)."""
    mesh = mesh or pm.SOLO
    tp, ep, dp, row = mesh.tp, mesh.ep, mesh.dp, mesh.model
    h = pm.gather_replicated(x, tp) if seq else x
    b, l, d = h.shape
    n = b * l
    e_loc = w1.shape[0]
    ht = h.reshape(n, d)
    mask = None if token_mask is None else token_mask.reshape(n).to(torch.float32)
    probs = torch.softmax(ht.float() @ router.float(), dim=-1)
    off = 0
    if aux and dp.on and not mesh.pp.on:  # a pipeline routes each block alone
        off = dp.index * n
        probs = pm.gather_live(probs, dp)
        mask = None if mask is None else pm.all_gather(mask, dp, 0)
    cap = moe_capacity(probs.shape[0], e_loc * ep.size, top_k, capacity_factor)
    r = moe_routing(probs, e_loc * ep.size, top_k, cap, token_mask=mask, aux=aux)
    expert, slot, keep, gate = (t[:, off:off + n] for t in r[:4])
    gate = pm.copy_to(row, gate)
    if seq:
        xt = pm.copy_to(ep, pm.gather_tokens(x, tp)).reshape(n, d)
    else:  # one view of x for the router and the bank, as one process has it
        xt = pm.copy_to(row, ht)

    e0 = ep.index * e_loc
    spare = e_loc * cap  # the row that dropped tokens (and other ranks' experts') go to
    local = (expert >= e0) & (expert < e0 + e_loc) & (keep > 0)
    rows = torch.where(local, (expert - e0) * cap + slot,
                       torch.full_like(slot, spare)).reshape(-1)
    # each kept (expert, slot) row receives exactly one token: the add is a copy
    expert_in = xt.new_zeros(spare + 1, d).index_add(0, rows, xt.repeat(top_k, 1))
    expert_in = expert_in[:spare].reshape(e_loc, cap, d)
    hid = F.gelu(torch.bmm(expert_in, w1) + b1[:, None, :], approximate="none")
    expert_out = torch.bmm(hid, w2)
    once = 1.0 if tp.index == 0 else 0.0  # the other tp ranks add b2 * 0
    expert_out = expert_out + pm.copy_to(tp, b2)[:, None, :] * once
    out_rows = torch.cat([expert_out.reshape(spare, d), expert_out.new_zeros(1, d)])
    # index_select's backward adds into the rows at once; an indexing
    # gather's sorts the rows and sums each one's duplicates in turn, which
    # serializes over the spare row's thousands
    picked = out_rows.index_select(0, rows).reshape(top_k, n, d).float()
    y = torch.sum(gate.to(x.dtype).float()[..., None] * picked, dim=0).reshape(b, l, d)
    if seq:
        y = pm.scatter_tokens(pm.reduce_from(y, ep), tp)
    else:
        y = pm.reduce_from(y, row)
    return y.to(x.dtype), r.aux


def moe_routing_reference(probs, n_experts: int, top_k: int, capacity: int,
                          token_mask=None, dtype=torch.float32):
    """The JAX package's ``moe_routing`` line for line: (dispatch (N, E, C)
    0/1, combine (N, E, C) gate-weighted, aux). For the tests."""
    _check_top_k(top_k, n_experts)
    n = probs.shape[0]
    mask = (torch.ones(n, device=probs.device) if token_mask is None
            else token_mask.to(torch.float32))
    probs = probs * mask[:, None]
    choices, gates = _choices(probs, n_experts, top_k)
    counts = torch.zeros(n_experts, device=probs.device)
    dispatch = torch.zeros(n, n_experts, capacity, device=probs.device)
    combine = torch.zeros(n, n_experts, capacity, device=probs.device)
    for (_, onehot), gate in zip(choices, gates):
        onehot = onehot * mask[:, None]
        pos_in_e = counts[None, :] + torch.cumsum(onehot, dim=0) - onehot
        pos = torch.sum(pos_in_e * onehot, dim=-1)
        keep = (pos < capacity).to(torch.float32) * mask
        sel = onehot * keep[:, None]
        # jax.nn.one_hot: a position past the capacity is a row of zeros
        slot = (pos.long()[:, None] == torch.arange(capacity, device=pos.device)
                ).to(torch.float32)
        dispatch = dispatch + sel[:, :, None] * slot[:, None, :]
        combine = combine + (sel * gate[:, None])[:, :, None] * slot[:, None, :]
        counts = counts + torch.sum(sel, dim=0)
    aux = _aux(choices[0][1], probs, mask, n_experts)
    return dispatch.to(dtype), combine.to(dtype), aux


def moe_ffn_reference(x, router, w1, b1, w2, b2, *, top_k: int = 1,
                      capacity_factor: float = 1.25, token_mask=None):
    """The JAX package's ``moe_ffn`` line for line, through the one-hot
    dispatch and combine einsums; for the tests only."""
    b, l, d = x.shape
    e = w1.shape[0]
    n = b * l
    xt = x.reshape(n, d)
    mask = None if token_mask is None else token_mask.reshape(n)
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    cap = moe_capacity(n, e, top_k, capacity_factor)
    dispatch, combine, aux = moe_routing_reference(probs, e, top_k, cap, mask, x.dtype)
    expert_in = torch.einsum("nec,nd->ecd", dispatch, xt)
    h = torch.einsum("ecd,edf->ecf", expert_in, w1) + b1[:, None, :]
    h = F.gelu(h, approximate="none")
    expert_out = torch.einsum("ecf,efd->ecd", h, w2) + b2[:, None, :]
    y = torch.einsum("nec,ecd->nd", combine, expert_out)
    return y.reshape(b, l, d), aux
