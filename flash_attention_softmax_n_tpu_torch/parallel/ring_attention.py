"""Ring attention: sequence-parallel softmax-N attention over a mesh axis.

Counterpart of ``flash_attention_softmax_n_tpu/parallel/ring_attention.py``.
Each rank holds one sequence shard of q, k and v, (B, H, L/p, E); the K/V
blocks rotate around the ring (``dist.batch_isend_irecv`` to the right
neighbour on the axis's group) while every rank folds each visiting block
into its running (o, m, l) state, the merge the flash kernel does across
its K/V tiles, lifted across ranks.

The ``+n`` term (SURVEY §7's hard invariant) enters exactly once: each
block runs with **n = 0** (K1 returns its o and lse) and the final
normalisation on the rank that owns the query row adds it:

    denom = n·exp(-m) + sum_blocks exp(lse_b - m)
    out   = sum_blocks o_b · exp(lse_b - m) / denom

Causality across the ring: rank ``my`` attends block ``b`` fully when
``b < my``, under the causal mask when ``b == my``, and not at all when
``b > my``: a skipped block launches nothing.

The backward keeps only (out, the global lse_n) per query row: each block's
gradients come from K5/K6 (``flash_attention_block_grads``) against the
global lse, with ``delta = rowsum(dout·out)`` computed once, and the f32
dk/dv accumulators rotate with their block, arriving home after p steps.
With GQA, K/V rotate unrepeated; each block is repeated locally and its
dk/dv summed over each kv head's query group.

The per-rank step functions (``block_mode``, ``ring_block_forward``,
``ring_fold``, ``ring_finish``, ``ring_block_backward``) take the visiting
block as an argument, so one process can also drive all p ranks' schedules
block by block, as ``chip_smoke.py`` does on one card. Kernel choice
follows the tensors' device: CUDA tensors launch K1 and K5/K6, CPU tensors
run their plain versions.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from flash_attention_softmax_n_tpu_torch.kernels.flash_attention import (
    flash_attention_block_grads,
    flash_attention_n_fused,
)
from flash_attention_softmax_n_tpu_torch.parallel.mesh import (
    axis_index,
    axis_size,
)

__all__ = ["ring_attention_n", "block_mode", "ring_init",
           "ring_block_forward", "ring_fold", "ring_finish",
           "ring_block_backward"]

NEG_INF = -1e30

Block = Optional[Tuple[torch.Tensor, ...]]


def block_mode(is_causal: bool, p: int, my: int, t: int) -> int:
    """At step ``t`` rank ``my`` holds block ``(my - t) mod p``: 0 attend
    fully, 1 causal within the block, 2 skip (a later block)."""
    owner = (my - t) % p
    if not is_causal or owner < my:
        return 0
    return 1 if owner == my else 2


def _repeat_heads(x: torch.Tensor, reps: int) -> torch.Tensor:
    """(B, KVH, S, E) -> (B, KVH*reps, S, E); identity at reps=1."""
    if reps == 1:
        return x
    b, kvh, s, e = x.shape
    return x[:, :, None].expand(b, kvh, reps, s, e).reshape(b, kvh * reps, s, e)


def _group_sum(g: torch.Tensor, reps: int) -> torch.Tensor:
    """Per-query-head kv gradients summed over each kv head's group."""
    if reps == 1:
        return g
    b, h, s, e = g.shape
    return g.reshape(b, h // reps, reps, s, e).sum(2)


def _causal(lq: int, lk: int, device) -> torch.Tensor:
    return torch.ones((lq, lk), dtype=torch.bool, device=device).tril(lk - lq)


def ring_init(q: torch.Tensor, v: torch.Tensor):
    """The empty running state (o_tilde, m, l), f32."""
    b, h, lq, _ = q.shape
    return (torch.zeros((b, h, lq, v.shape[-1]), dtype=torch.float32,
                        device=q.device),
            torch.full((b, h, lq), NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, h, lq), dtype=torch.float32, device=q.device))


def ring_block_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       mode: int, scale: float, implementation: str) -> Block:
    """softmax-0 attention of the local q against one visiting block:
    (o_b in q's dtype, lse_b f32) with lse_b = log(sum_j exp(s_j)), or None
    for a skipped block. ``"pallas"`` runs K1 (its plain version on CPU
    tensors) with n = 0; ``"xla"`` forms the block's f32 scores."""
    if mode == 2:
        return None
    reps = q.shape[1] // k.shape[1]
    k, v = _repeat_heads(k, reps), _repeat_heads(v, reps)
    if implementation == "pallas":
        return flash_attention_n_fused(q, k, v, softmax_n_param=0.0,
                                       scale=scale, is_causal=mode == 1,
                                       return_residuals=True)
    s = torch.einsum("bhle,bhse->bhls", q.float(), k.float()) * scale
    if mode == 1:
        s = s.masked_fill(~_causal(q.shape[2], k.shape[2], q.device), NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = torch.sum(e, dim=-1, keepdim=True)
    o = torch.einsum("bhls,bhsv->bhlv", (e / l).to(v.dtype), v)
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def ring_fold(state, block: Block):
    """Fold one block's (o_b, lse_b) into the running state: the block adds
    exp(lse_b - m) o_b (o_b is block-normalised, so o_b exp(lse_b) is its
    raw sum), all in f32 with guards for rows that have seen nothing."""
    if block is None:
        return state
    o_t, m, l = state
    o_b, lse_b = block
    m_new = torch.maximum(m, lse_b)
    m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_safe))
    w_b = torch.where(lse_b <= NEG_INF / 2, 0.0, torch.exp(lse_b - m_safe))
    o_t = o_t * alpha[..., None] + o_b.float() * w_b[..., None]
    return o_t, m_new, l * alpha + w_b


def ring_finish(state, n: float, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final normalisation, where the ``+n`` enters once, in the running
    max's numeraire: (out in ``dtype``, lse_n f32, the global softmax-N
    logsumexp, so p_ij == exp(s_ij - lse_n_i))."""
    o_t, m, l = state
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    denom = l + n * torch.exp(torch.clamp(-m_safe, max=80.0))
    safe = torch.where(denom == 0.0, 1.0, denom)
    out = o_t / safe[..., None]
    if n > 0:
        out = torch.where((l == 0.0)[..., None], 0.0, out)
    return out.to(dtype), m_safe + torch.log(safe)


def ring_block_backward(q, k, v, out, dout, lse_n, delta, *, mode: int,
                        scale: float, implementation: str) -> Block:
    """(dq_b, dk_b, dv_b), f32, of one visiting block against the global
    lse_n: p = exp(s - lse_n) are the true softmax-N probabilities and
    ds = p (dout·vᵀ - delta); dk_b/dv_b are summed to the block's kv heads.
    None for a skipped block. ``"pallas"`` runs K5/K6 (their plain version
    on CPU tensors)."""
    if mode == 2:
        return None
    reps = q.shape[1] // k.shape[1]
    kk, vv = _repeat_heads(k, reps), _repeat_heads(v, reps)
    if implementation == "pallas":
        dq, dk, dv = flash_attention_block_grads(
            q, kk, vv, out, lse_n, dout, scale=scale, is_causal=mode == 1,
            delta=delta)
        return (dq.float(), _group_sum(dk.float(), reps),
                _group_sum(dv.float(), reps))
    s = torch.einsum("bhle,bhse->bhls", q.float(), kk.float()) * scale
    if mode == 1:
        s = s.masked_fill(~_causal(q.shape[2], kk.shape[2], q.device), NEG_INF)
    p = torch.exp(s - lse_n[..., None])
    do = dout.float()
    dv = torch.einsum("bhls,bhlv->bhsv", p, do)
    ds = p * (torch.einsum("bhlv,bhsv->bhls", do, vv.float()) - delta[..., None])
    dq = torch.einsum("bhls,bhse->bhle", ds, kk.float()) * scale
    dk = torch.einsum("bhls,bhle->bhse", ds, q.float()) * scale
    return dq, _group_sum(dk, reps), _group_sum(dv, reps)


def _rotation(group, p: int) -> Callable:
    """``rotate(tensors)`` sends each tensor to the right neighbour on the
    group and receives the left one's, asynchronously; it returns a
    function that waits and gives the received tensors."""
    me = dist.get_rank(group)
    right = dist.get_global_rank(group, (me + 1) % p)
    left = dist.get_global_rank(group, (me - 1) % p)

    def rotate(tensors: Sequence[torch.Tensor]):
        sends = [t.contiguous() for t in tensors]
        recvs = [torch.empty_like(t) for t in sends]
        ops = []
        for s, r in zip(sends, recvs):
            ops += [dist.P2POp(dist.isend, s, right, group),
                    dist.P2POp(dist.irecv, r, left, group)]
        reqs = dist.batch_isend_irecv(ops)

        def wait():
            for req in reqs:
                req.wait()
            del sends[:]
            return recvs

        return wait

    return rotate


def _ring_forward(q, k, v, *, p, my, rotate, scale, n, is_causal,
                  implementation):
    state = ring_init(q, v)
    for t in range(p):
        # the next block travels while this one is folded in
        pending = rotate((k, v)) if t < p - 1 else None
        block = ring_block_forward(q, k, v, mode=block_mode(is_causal, p, my, t),
                                   scale=scale, implementation=implementation)
        state = ring_fold(state, block)
        if pending is not None:
            k, v = pending()
    return ring_finish(state, n, q.dtype)


def _ring_backward(q, k, v, out, dout, lse_n, *, p, my, rotate, scale,
                   is_causal, implementation):
    delta = torch.sum(dout.float() * out.float(), dim=-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for t in range(p):
        pending = rotate((k, v)) if t < p - 1 else None
        g = ring_block_backward(q, k, v, out, dout, lse_n, delta,
                                mode=block_mode(is_causal, p, my, t),
                                scale=scale, implementation=implementation)
        if g is not None:
            dq += g[0]
            dk += g[1]
            dv += g[2]
        if p > 1:
            # the accumulators travel with their block: home after p steps
            dk, dv = rotate((dk, dv))()
        if pending is not None:
            k, v = pending()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """The ring forward, and the ring-aware backward from (out, lse_n)."""

    @staticmethod
    def forward(ctx, q, k, v, cfg):
        out, lse_n = _ring_forward(q, k, v, **cfg)
        ctx.save_for_backward(q, k, v, out, lse_n)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse_n = ctx.saved_tensors
        cfg = {k_: v_ for k_, v_ in ctx.cfg.items() if k_ != "n"}
        dq, dk, dv = _ring_backward(q, k, v, out, dout.contiguous(), lse_n,
                                    **cfg)
        return dq, dk, dv, None


def ring_attention_n(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh,
    axis_name: str = "sp",
    softmax_n_param: float = 0.0,
    scale: Optional[float] = None,
    is_causal: bool = True,
    implementation: str = "auto",
    attn_mask=None,
) -> torch.Tensor:
    """Sequence-parallel softmax-N attention over ``mesh``'s ``axis_name``.

    q (B, H, L/p, E) and k/v (B, KVH, L/p, E|Ev) are this rank's sequence
    shard (H % KVH == 0); returns this rank's shard of the output,
    differentiable through the ring-aware backward (module docstring).
    Every rank of the axis calls it.

    ``implementation``: ``'pallas'`` runs K1 per visiting block and K5/K6
    against the global lse (their plain versions on CPU tensors), so no
    rank forms (L/p, L/p) scores outside a kernel; ``'xla'`` forms each
    block's f32 scores; ``'auto'`` takes ``'pallas'`` when E == Ev.

    Masking, as in JAX: ``attn_mask`` is refused. With ``is_causal`` and
    right-padded batches, padded keys sit after every real query and are
    never attended, and padded query rows are left out by the loss mask.
    Dropout is refused at the model layer.
    """
    if attn_mask is not None:
        raise NotImplementedError(
            "ring attention takes no attn_mask: causal + right padding "
            "needs none (padded keys are causally invisible to real "
            "queries; mask padded rows in the LOSS), and arbitrary masks "
            "would need a rotating mask block per ring step — use the "
            "single-device kernel (flash_attention_n) for masked/bias "
            "attention")
    if implementation not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown implementation {implementation!r}; "
                         "expected 'auto', 'pallas', or 'xla'")
    can_pallas = q.shape[-1] == v.shape[-1]
    if implementation == "pallas" and not can_pallas:
        raise ValueError("pallas ring path requires E == Ev; use "
                         "implementation='xla'")
    if implementation == "auto":
        implementation = "pallas" if can_pallas else "xla"
    if axis_name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis_name!r}: "
                         f"{mesh.mesh_dim_names}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"{q.shape[1]} query heads do not group over "
                         f"{k.shape[1]} kv heads")
    p = axis_size(mesh, axis_name)
    cfg = dict(p=p, my=axis_index(mesh, axis_name),
               rotate=_rotation(mesh.get_group(axis_name), p) if p > 1 else None,
               scale=float(q.shape[-1] ** -0.5 if scale is None else scale),
               n=float(softmax_n_param), is_causal=bool(is_causal),
               implementation=implementation)
    return _RingAttention.apply(q, k, v, cfg)
