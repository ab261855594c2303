"""Paged attention, the port of dtdl_tpu/ops/paged_attention.py.

:func:`paged_attention` has the exact contract of the JAX function: ``q``
[B, H, S, D] already roped, pools ``[n_pages, H, page, D]`` (f32/bf16, or
int8/float8_e4m3fn with ``key_scale``/``value_scale`` [n_pages, H, page]),
``page_table`` [B, n_ptab] int32, ``pos`` [B] (the clamped positions),
``active`` [B]; returns [B, H, S, D] in q's dtype with inactive rows zero.

On a CUDA tensor it launches the hand-written kernel
``csrc/paged_attention.cu`` (kernel K4, the port of ``_kernel``), which walks
each row's page table and reads only pages 0..last.  On a CPU tensor it
runs :func:`paged_attention_reference`, the engine's gather path
(dtdl_tpu/models/transformer.py, the ``paged_kernel=False`` attend) with
inactive rows zeroed.
"""

from __future__ import annotations

import functools

import torch

from dtdl_tpu_torch import kernels

NEG_INF = -1e30


def _gather(pool, page_table):
    """[n_pages, H, page, ...] pool -> the [B, H, n_ptab * page, ...]
    logical view through the page table."""
    pages = pool[page_table.long()]                 # [B, n_ptab, H, pg, ..]
    pages = pages.transpose(1, 2)                   # [B, H, n_ptab, pg, ..]
    b, h, n, pg = pages.shape[:4]
    return pages.reshape(b, h, n * pg, *pages.shape[4:])


def paged_attention_reference(q, pages_k, pages_v, page_table, pos, active,
                              *, scale, key_scale=None, value_scale=None):
    """The gather path's op order over the whole table: f32 logits ×
    key scale, × scale, mask at -1e30 past ``pos + i``, softmax, × value
    scale, weights cast to q's dtype, P·V; inactive rows are zeros."""
    s_new = q.shape[2]
    keys = _gather(pages_k, page_table).to(q.dtype)
    values = _gather(pages_v, page_table).to(q.dtype)
    logits = torch.matmul(q.float(), keys.float().transpose(-1, -2))
    if key_scale is not None:
        logits = logits * _gather(key_scale, page_table).float()[:, :, None]
    cols = torch.arange(keys.shape[2], device=q.device)
    qpos = (pos.long()[:, None] + torch.arange(s_new, device=q.device))
    mask = cols[None, None, None, :] <= qpos[:, None, :, None]
    logits = torch.where(mask, logits * scale,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    if value_scale is not None:
        probs = probs * _gather(value_scale, page_table).float()[:, :, None]
    o = torch.matmul(probs.to(q.dtype).float(), values.float()).to(q.dtype)
    live = (active != 0)[:, None, None, None]
    return torch.where(live, o, torch.zeros_like(o))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def kv_splits(b: int, h: int, s_new: int, n_ptab: int, sms: int) -> int:
    """How many ranges to split each row's live pages into: enough that
    the (row, head, 16-query-row tile) blocks fill twice the card's SMs,
    at most 16 and at most the table's pages; the kernel sizes the ranges
    from each row's position and merges the partials.  Shapes only, no
    look at the data (a device read would stall the host)."""
    blocks = b * h * -(-s_new // 16)
    if blocks >= sms:
        return 1
    return min(16, -(-2 * sms // blocks), n_ptab)


_POOL_KINDS = {torch.float32: kernels.F32, torch.bfloat16: kernels.BF16,
               torch.int8: kernels.INT8,
               torch.float8_e4m3fn: kernels.FP8_E4M3}
_HEAD_DIMS = (16, 32, 64, 128)


def paged_attention(q, pages_k, pages_v, page_table, pos, active, *,
                    scale, key_scale=None, value_scale=None):
    """Attend ``q`` against a paged arena (see module docstring)."""
    if (key_scale is None) != (value_scale is None):
        raise ValueError("key_scale and value_scale must be passed together")
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, pages_k, pages_v, page_table, pos, active, scale=scale,
            key_scale=key_scale, value_scale=value_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, "
                         f"got {q.device}")
    b, h, s_new, d = q.shape
    n_pages, hp, page, dp = pages_k.shape
    if (hp, dp) != (h, d) or pages_v.shape != pages_k.shape:
        raise ValueError(f"pools {tuple(pages_k.shape)} / "
                         f"{tuple(pages_v.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_attention q must be f32 or bf16, "
                        f"got {q.dtype}")
    if d not in _HEAD_DIMS or not 1 <= page <= 256:
        raise ValueError(f"head_dim must be one of {_HEAD_DIMS} and page "
                         f"size in 1..256, got {d} and {page}")
    quant = key_scale is not None
    kind = _POOL_KINDS.get(pages_k.dtype)
    if pages_v.dtype != pages_k.dtype or kind is None \
            or quant != (kind in (kernels.INT8, kernels.FP8_E4M3)) \
            or (not quant and pages_k.dtype != q.dtype):
        raise TypeError(
            f"pools must be q's dtype ({q.dtype}), or int8/float8_e4m3fn "
            f"with scales; got {pages_k.dtype} "
            f"{'with' if quant else 'without'} scales")
    scale_kind = kernels.F32
    if quant:
        if key_scale.dtype != value_scale.dtype \
                or key_scale.dtype not in (torch.float32, torch.bfloat16) \
                or key_scale.shape != (n_pages, h, page) \
                or value_scale.shape != key_scale.shape:
            raise TypeError("key/value scales must be f32 or bf16 "
                            f"[{n_pages}, {h}, {page}]")
        key_scale, value_scale = (key_scale.contiguous(),
                                  value_scale.contiguous())
        scale_kind = (kernels.BF16 if key_scale.dtype == torch.bfloat16
                      else kernels.F32)
    n_ptab = page_table.shape[1]
    if page_table.shape != (b, n_ptab) or pos.shape != (b,) \
            or active.shape != (b,):
        raise ValueError("page_table must be [B, n_ptab], pos and active [B]")
    q = q.contiguous()
    pages_k, pages_v = pages_k.contiguous(), pages_v.contiguous()
    for t in (q, pages_k, pages_v):
        if t.device != q.device or t.data_ptr() % 16:
            raise ValueError("paged_attention tensors must be 16-byte "
                             "aligned and on one device")
    table = page_table.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    active = active.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    n_splits = kv_splits(b, h, s_new, n_ptab, _sm_count(q.device))
    part_acc = part_ml = None
    if n_splits > 1:
        rows = b * h * s_new * n_splits
        part_acc = torch.empty(rows * d, dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty(rows * 2, dtype=torch.float32,
                              device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = kernels.lib().dtdl_paged_attention(
        q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
        key_scale.data_ptr() if quant else None,
        value_scale.data_ptr() if quant else None,
        table.data_ptr(), pos.data_ptr(), active.data_ptr(), out.data_ptr(),
        part_acc.data_ptr() if n_splits > 1 else None,
        part_ml.data_ptr() if n_splits > 1 else None,
        b, h, s_new, d, n_ptab, page,
        kernels.BF16 if q.dtype == torch.bfloat16 else kernels.F32,
        kind, scale_kind, n_splits, float(scale), stream)
    kernels.check("paged_attention", code)
    kernels.LAUNCHES["paged_attention"] += 1
    return out
