"""Device-dispatching wrappers around the port's Hopper kernels.

Port of ``repro/kernels/ops.py`` (the combine and its sharded-plane uses,
the refresh scatter, the segment sum, the fused layer and flash attention).  The tensor's
device decides the path: a CUDA tensor launches the hand-written kernel
(``csrc/*.cu``, built on first use by ``build.py``) or raises; a CPU tensor
runs the plain PyTorch version in ``ref.py``.  There is
no fallback from a failed build or launch to the plain version.

Each launch adds one to its kernel's counter (``kernel_launches()``) and to
its kernel's count on the card it ran on (``kernel_launches_by_device()``),
so a run can show that its main path went through the kernels, and on
which cards.  The two layer kernels sit inside ``torch.autograd.Function``s
and flash attention in a custom op (``torch.library.custom_op``) whose
autograd is registered; their backwards are the reference's VJPs
(``repro/kernels/ops.py:343-357``, ``:414-445`` and ``:458-480``), written
as torch ops: the reference has no Pallas backward either.
"""
from __future__ import annotations

import threading
from contextlib import nullcontext
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import ref
from .build import library

__all__ = ["assemble_features", "assemble_features_sharded", "gather_rows",
           "cache_combine_legacy", "update_cache_rows", "scatter_rows_",
           "segment_weighted_sum_regular", "fused_gnn_update",
           "flash_attention", "FLASH_HEAD_DIMS", "kernel_launches",
           "kernel_launches_by_device", "reset_kernel_launches", "KERNELS",
           "COMBINE_ROW_BLOCK", "UPDATE_ROW_BLOCK", "MAX_RING_BYTES"]

# kernel name -> the wrapper's counter; bumped only where a kernel launches
KERNELS = ("cache_combine", "cache_combine_pipelined", "cache_combine_legacy",
           "cache_update", "cache_update_pipelined", "fused_update",
           "segment_sum", "flash_attention")
# kernel -> the library (csrc source) that holds it, where the names differ
_LIBRARY = {"cache_combine_pipelined": "cache_combine",
            "cache_combine_legacy": "cache_combine",
            "cache_update_pipelined": "cache_update"}
_launches: Dict[str, int] = {k: 0 for k in KERNELS}
# (kernel, card ordinal) -> launches on that card
_launches_on: Dict[Tuple[str, int], int] = {}
_launch_lock = threading.Lock()   # trainer threads launch concurrently


def kernel_launches() -> Dict[str, int]:
    """Launches per kernel since the last reset."""
    with _launch_lock:
        return dict(_launches)


def kernel_launches_by_device() -> Dict[str, Dict[int, int]]:
    """Launches per kernel and card ordinal since the last reset (a card
    that launched a kernel no time is absent from its dict)."""
    out: Dict[str, Dict[int, int]] = {k: {} for k in KERNELS}
    with _launch_lock:
        for (kernel, card), n in _launches_on.items():
            out[kernel][card] = n
    return out


def reset_kernel_launches() -> None:
    with _launch_lock:
        for k in _launches:
            _launches[k] = 0
        _launches_on.clear()


def _launch(kernel: str, symbol: str, on: torch.Tensor, *args) -> None:
    """Call one C entry point on ``on``'s device and that device's current
    stream (appended to ``args``) and count the launch; a non-zero
    ``cudaGetLastError`` raises.  The device guard matters where a caller's
    current device is another card (a peer gather under the reader's
    transfer stream): a kernel launches on the current device, and CUDA
    refuses a stream of another one."""
    name = _LIBRARY.get(kernel, kernel)
    lib = library(name)
    with torch.cuda.device(on.device) if on.is_cuda else nullcontext():
        rc = getattr(lib, symbol)(*args, _stream(on))
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc)
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc} "
                           f"({msg.decode() if msg else '?'})")
    key = (kernel, on.device.index)
    with _launch_lock:
        _launches[kernel] += 1
        _launches_on[key] = _launches_on.get(key, 0) + 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_tensors(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """All on one device and contiguous (the kernels index raw pointers)."""
    dev = next(t.device for t in tensors if t is not None)
    for t in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _index(x: Union[np.ndarray, torch.Tensor],
           device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(x)
    return t.to(device=device, dtype=torch.int32).contiguous()


def _depth(pipeline_depth: int) -> int:
    depth = int(pipeline_depth)
    if not 1 <= depth <= 4:
        raise ValueError(f"pipeline depth must be in 1..4, got {depth}")
    return depth


def _check_ring(kernel: str, depth: int, rows: int, f: int,
                elem: int) -> None:
    ring = depth * rows * f * elem
    if ring > MAX_RING_BYTES:
        raise ValueError(f"{kernel} ring of {ring} bytes (depth {depth}, "
                         f"{rows} rows of {f}) exceeds the {MAX_RING_BYTES} "
                         f"bytes of shared memory a block may use")


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
COMBINE_ROW_BLOCK = 8        # output rows per staged block of K4
UPDATE_ROW_BLOCK = 8         # rows per staged block of K6
MAX_RING_BYTES = 232_448     # shared memory one block may use on Hopper


# ------------------------------------------------------------------ combine


def assemble_features(cache: Optional[torch.Tensor], miss: torch.Tensor,
                      slots, miss_index,
                      pipeline_depth: int = 1) -> torch.Tensor:
    """Assemble the positional layer-0 block from the device-resident hot
    cache and the shipped unique-miss rows: ``out[i] = cache[slots[i]]``
    when ``slots[i] >= 0`` else ``miss[miss_index[i]]`` (the paper's
    Feature Duplicator, on the device after the interconnect).

    ``cache=None`` is the cache-less dedup path (every slot is -1); ``miss``
    may be empty when every slot hits.  The index tables may be host numpy
    or tensors; they are moved to the miss block's device as int32.  A CUDA
    block launches K1 at ``pipeline_depth`` 1 and K4 (the same function
    through a copy ring) at 2..4; every depth gives the same bits.  No
    gradient: layer-0 inputs are data.
    """
    depth = _depth(pipeline_depth)
    slots = _index(slots, miss.device)
    miss_index = _index(miss_index, miss.device)
    if _on_cpu(miss):
        return ref.assemble_features(cache, miss, slots, miss_index)
    if cache is not None and (cache.dtype != miss.dtype
                              or cache.shape[1] != miss.shape[1]):
        raise ValueError("cache and miss blocks differ in dtype or width")
    suffix = _SUFFIX.get(miss.dtype)
    if suffix is None:
        raise TypeError(f"cache combine: unsupported dtype {miss.dtype}")
    _check_tensors("assemble_features", cache, miss, slots, miss_index)
    n, f = int(slots.shape[0]), int(miss.shape[1])
    out = torch.empty((n, f), dtype=miss.dtype, device=miss.device)
    if n == 0:
        return out
    ptrs = (cache.data_ptr() if cache is not None else None,
            miss.data_ptr() if miss.shape[0] else None,
            slots.data_ptr(), miss_index.data_ptr(), out.data_ptr(), n, f)
    if depth == 1:
        _launch("cache_combine", f"cache_combine_{suffix}", miss, *ptrs)
    else:
        _check_ring("K4", depth, COMBINE_ROW_BLOCK, f, miss.element_size())
        _launch("cache_combine_pipelined", f"cache_combine_pipelined_{suffix}",
                miss, *ptrs, depth)
    return out


def gather_rows(block: torch.Tensor, slots,
                pipeline_depth: int = 1) -> torch.Tensor:
    """``block[slots]``: the peer-serve half of the sharded plane's row
    exchange (the owner shard reads the requested rows before the hop).
    A combine whose every slot hits and whose miss block is empty, so K1 or
    K4 serves it on a card, bit-equal at every depth."""
    slots = _index(slots, block.device)
    return assemble_features(block, block.new_empty((0, block.shape[1])),
                             slots, torch.zeros_like(slots), pipeline_depth)


def assemble_features_sharded(cache: Optional[torch.Tensor],
                              sources: Sequence[torch.Tensor], slots,
                              miss_index,
                              pipeline_depth: int = 1) -> torch.Tensor:
    """Shard-aware combine: ``cache`` is the trainer's LOCAL shard block and
    the miss source arrives as an ordered list of device blocks, the rows
    pulled from peer shards (ring order) then the fresh host-shipped rows.
    They are concatenated on the device into the one combined source that
    the union lookup's ``miss_index`` addresses, then combined as in
    ``assemble_features``."""
    sources = [s for s in sources if int(s.shape[0])]
    if not sources:
        if cache is None:
            raise ValueError("assemble_features_sharded: no source rows")
        miss = cache.new_empty((0, cache.shape[1]))
    elif len(sources) == 1:
        miss = sources[0]
    else:
        miss = torch.cat(sources)
    return assemble_features(cache, miss, slots, miss_index, pipeline_depth)


def cache_combine_legacy(cache: torch.Tensor, miss: torch.Tensor, sel,
                         row) -> torch.Tensor:
    """The legacy combine, kept as a parity baseline (no path of the
    trainer runs it): ``out[i] = cache[row[i]]`` when ``sel[i] == 0`` else
    ``miss[row[i]]``.  cache [K, F] and miss [M, F] with K, M >= 1; sel /
    row int [N].  A CUDA block launches K7."""
    sel = _index(sel, cache.device)
    row = _index(row, cache.device)
    if _on_cpu(cache):
        return ref.cache_combine_legacy(cache, miss, sel, row)
    suffix = _SUFFIX.get(cache.dtype)
    if suffix is None or miss.dtype != cache.dtype:
        raise TypeError(f"legacy combine: unsupported dtypes {cache.dtype}, "
                        f"{miss.dtype}")
    if miss.shape[1] != cache.shape[1] or not (cache.shape[0]
                                               and miss.shape[0]):
        raise ValueError("legacy combine: non-empty cache and miss blocks "
                         "of one width expected")
    _check_tensors("cache_combine_legacy", cache, miss, sel, row)
    n, f = int(sel.shape[0]), int(cache.shape[1])
    out = torch.empty((n, f), dtype=cache.dtype, device=cache.device)
    if n:
        _launch("cache_combine_legacy", f"cache_combine_legacy_{suffix}",
                cache, cache.data_ptr(), miss.data_ptr(), sel.data_ptr(),
                row.data_ptr(), out.data_ptr(), n, f)
    return out


# ---------------------------------------------------- refresh scatter (K5/K6)

def update_cache_rows(cache: torch.Tensor, rows: torch.Tensor, slots,
                      pipeline_depth: int = 1) -> torch.Tensor:
    """Scatter admitted rows into a hot block during a cache refresh:
    ``out = cache; out[slots[i]] = rows[i]``, the last writer winning on a
    slot named twice.

    An empty update returns ``cache`` itself.  Otherwise the slots are
    deduped keep-last on the host (GPU blocks run in no order), and the
    result is a new block: ``cache`` is never written, so a combine still
    reading the old version reads the old rows.  ``rows`` must lie on
    ``cache``'s device; ``slots`` may be host numpy or a tensor.  A CPU
    block takes the plain version; a CUDA block launches K5 at
    ``pipeline_depth`` 1 and K6 at 2..4, or raises.
    """
    if isinstance(slots, torch.Tensor):
        slots = slots.cpu().numpy()
    slots = np.asarray(slots, dtype=np.int32)
    if slots.shape[0] == 0:
        return cache
    # keep-last dedupe: unique() keeps the first occurrence, so scan the
    # reversed list and map the indices back
    _, first_in_rev = np.unique(slots[::-1], return_index=True)
    keep = np.sort(slots.shape[0] - 1 - first_in_rev)
    keep_t = torch.from_numpy(keep).to(rows.device)
    slots = slots[keep]
    if _on_cpu(cache):
        return ref.cache_update(cache, rows[keep_t].to(cache.dtype),
                                torch.from_numpy(slots))
    out = cache.clone()
    depth = int(pipeline_depth)
    m = slots.shape[0]
    mp = -(-m // UPDATE_ROW_BLOCK) * UPDATE_ROW_BLOCK if depth > 1 else m
    # rows padded to the row block in the same gather that dedupes them;
    # pad rows are staged by K6 but never written
    live = torch.zeros((mp, rows.shape[1]), dtype=cache.dtype,
                       device=cache.device)
    torch.index_select(rows.to(cache.dtype), 0, keep_t, out=live[:m])
    scatter_rows_(out, live, _index(slots, cache.device), depth)
    return out


def scatter_rows_(out: torch.Tensor, rows: torch.Tensor,
                  slots: torch.Tensor, pipeline_depth: int = 1) -> None:
    """In place: ``out[slots[i]] = rows[i]`` for ``i < len(slots)``, with
    UNIQUE slots (``update_cache_rows`` dedupes first).  ``rows`` may hold
    more rows than ``slots`` (K6's padding, never written).  A CPU tensor
    takes the plain indexed copy; a CUDA tensor launches K5 at depth 1 and
    K6 at depth 2..4, or raises."""
    depth = _depth(pipeline_depth)
    m = int(slots.shape[0])
    if _on_cpu(out):
        out[slots.long()] = rows[:m].to(out.dtype)
        return
    suffix = _SUFFIX.get(out.dtype)
    if suffix is None or rows.dtype != out.dtype:
        raise TypeError(f"cache update: unsupported dtypes {out.dtype}, "
                        f"{rows.dtype}")
    if slots.dtype != torch.int32 or rows.shape[1] != out.shape[1] \
            or rows.shape[0] < m:
        raise ValueError("cache update: int32 slots and one row per slot "
                         "of the block's width expected")
    _check_tensors("scatter_rows_", out, rows, slots)
    if m == 0:
        return
    f = int(out.shape[1])
    if depth == 1:
        _launch("cache_update", f"cache_update_{suffix}", out,
                out.data_ptr(), rows.data_ptr(), slots.data_ptr(), m, f)
        return
    mp = int(rows.shape[0])
    if mp % UPDATE_ROW_BLOCK:
        raise ValueError(f"K6 takes rows padded to a multiple of "
                         f"{UPDATE_ROW_BLOCK}, got {mp}")
    _check_ring("K6", depth, UPDATE_ROW_BLOCK, f, out.element_size())
    _launch("cache_update_pipelined", f"cache_update_pipelined_{suffix}",
            out, out.data_ptr(), rows.data_ptr(), slots.data_ptr(), m, mp, f,
            depth)


# -------------------------------------------------------------- segment sum

_SEGSUM_SYMBOL = {torch.float32: "segment_sum_f32",
                  torch.bfloat16: "segment_sum_bf16"}


def _segsum_forward(x_nbr: torch.Tensor, w_edge: torch.Tensor,
                    fanout: int) -> torch.Tensor:
    if _on_cpu(x_nbr):
        return ref.segment_weighted_sum_regular(x_nbr, w_edge, fanout)
    symbol = _SEGSUM_SYMBOL.get(x_nbr.dtype)
    if symbol is None or w_edge.dtype != x_nbr.dtype:
        raise TypeError(f"segment sum: unsupported dtypes {x_nbr.dtype}, "
                        f"{w_edge.dtype}")
    x_nbr, w_edge = x_nbr.contiguous(), w_edge.contiguous()
    _check_tensors("segment_weighted_sum_regular", x_nbr, w_edge)
    d, f = x_nbr.shape[0] // fanout, int(x_nbr.shape[1])
    out = torch.empty((d, f), dtype=x_nbr.dtype, device=x_nbr.device)
    _launch("segment_sum", symbol, x_nbr, x_nbr.data_ptr(),
            w_edge.data_ptr(), out.data_ptr(), d, f, int(fanout))
    return out


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_nbr, w_edge, fanout):
        ctx.save_for_backward(x_nbr, w_edge)
        ctx.fanout = fanout
        return _segsum_forward(x_nbr, w_edge, fanout)

    @staticmethod
    def backward(ctx, g):
        x_nbr, w_edge = ctx.saved_tensors
        g_rep = g.float().repeat_interleave(ctx.fanout, dim=0)
        d_xn = d_we = None
        if ctx.needs_input_grad[0]:
            d_xn = (g_rep * w_edge.float()[:, None]).to(x_nbr.dtype)
        if ctx.needs_input_grad[1]:
            d_we = (g_rep * x_nbr.float()).sum(-1).to(w_edge.dtype)
        return d_xn, d_we, None


def segment_weighted_sum_regular(x_nbr: torch.Tensor, w_edge: torch.Tensor,
                                 fanout: int) -> torch.Tensor:
    """Regular-layout weighted segment sum, differentiable.

    x_nbr: [D*fanout, F]; w_edge: [D*fanout] -> [D, F]:
    ``out[d] = sum_j w_edge[d*fanout+j] * x_nbr[d*fanout+j]`` in f32.
    """
    return _SegmentSum.apply(x_nbr, w_edge, int(fanout))


# ------------------------------------------------------------- fused layer


def _fused_forward(x_self, x_nbr, w_edge, self_scale, w_self, w_agg, bias,
                   fanout: int) -> torch.Tensor:
    if _on_cpu(x_self):
        return ref.fused_gnn_update(x_self, x_nbr, w_edge, self_scale,
                                    w_self, w_agg, bias, fanout)
    ts = [x_self, x_nbr, w_edge, self_scale, w_self, w_agg, bias]
    if any(t is not None and t.dtype != torch.float32 for t in ts):
        raise TypeError("fused GNN layer kernel takes float32 tensors")
    x_self, x_nbr, w_edge, self_scale, w_self, w_agg = (
        t.contiguous() for t in ts[:6])
    bias = bias.contiguous() if bias is not None else None
    _check_tensors("fused_gnn_update", x_self, x_nbr, w_edge, self_scale,
                  w_self, w_agg, bias)
    d, f = (int(s) for s in x_self.shape)
    o = int(w_self.shape[1])
    if x_nbr.shape != (d * fanout, f) or w_agg.shape != w_self.shape \
            or w_self.shape[0] != f:
        raise ValueError("fused GNN layer: inconsistent shapes")
    out = torch.empty((d, o), dtype=torch.float32, device=x_self.device)
    _launch("fused_update", "fused_update_f32", x_self,
            x_self.data_ptr(), x_nbr.data_ptr(), w_edge.data_ptr(),
            self_scale.data_ptr(), w_self.data_ptr(), w_agg.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            d, f, o, int(fanout))
    return out


class _FusedUpdate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_self, x_nbr, w_edge, self_scale, w_self, w_agg, bias,
                fanout):
        ctx.save_for_backward(x_self, x_nbr, w_edge, self_scale, w_self,
                              w_agg)
        ctx.fanout = fanout
        ctx.has_bias = bias is not None
        return _fused_forward(x_self, x_nbr, w_edge, self_scale, w_self,
                              w_agg, bias, fanout)

    @staticmethod
    def backward(ctx, g):
        x_self, x_nbr, w_edge, self_scale, w_self, w_agg = ctx.saved_tensors
        need = ctx.needs_input_grad
        fanout = ctx.fanout
        g32 = g.float()
        xs32 = x_self.float()
        ss32 = self_scale.float()
        d_xs = d_xn = d_we = d_ss = d_wself = d_wagg = d_b = None
        if need[0] or need[3]:
            gws = g32 @ w_self.float().T                          # [D, F]
            if need[0]:
                d_xs = (gws * ss32[:, None]).to(x_self.dtype)
            if need[3]:
                d_ss = (gws * xs32).sum(-1).to(self_scale.dtype)
        if need[4]:
            d_wself = ((xs32 * ss32[:, None]).T @ g32).to(w_self.dtype)
        if need[5]:
            # recompute the aggregation once (cheap next to the products)
            agg = ref.segment_weighted_sum_regular(x_nbr, w_edge,
                                                   fanout).float()
            d_wagg = (agg.T @ g32).to(w_agg.dtype)
        if need[1] or need[2]:
            d_agg_rep = (g32 @ w_agg.float().T).repeat_interleave(fanout,
                                                                  dim=0)
            if need[1]:
                d_xn = (d_agg_rep * w_edge.float()[:, None]).to(x_nbr.dtype)
            if need[2]:
                d_we = (d_agg_rep * x_nbr.float()).sum(-1).to(w_edge.dtype)
        if ctx.has_bias and need[6]:
            d_b = g32.sum(0).to(w_self.dtype)
        return d_xs, d_xn, d_we, d_ss, d_wself, d_wagg, d_b, None


def fused_gnn_update(x_self: torch.Tensor, x_nbr: torch.Tensor,
                     w_edge: torch.Tensor, self_scale: torch.Tensor,
                     w_self: torch.Tensor, w_agg: torch.Tensor,
                     bias: Optional[torch.Tensor],
                     fanout: int) -> torch.Tensor:
    """Fused aggregate+update GNN layer (paper Section IV-C datapath),
    differentiable:
    ``(self_scale ⊙ x_self) @ w_self + segsum(w_edge ⊙ x_nbr) @ w_agg + b``.
    """
    return _FusedUpdate.apply(x_self, x_nbr, w_edge, self_scale, w_self,
                              w_agg, bias, int(fanout))


# ---------------------------------------------------------- flash attention

FLASH_HEAD_DIMS = (16, 32, 64, 112, 128)   # K8's template instances
FLASH_MAX_TILE = 512                  # the reference's q_block / kv_tile cap


def _flash_check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_block: int) -> int:
    """Validate the shapes; the q block ``min(q_block, S)``."""
    if q.dim() != 5 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[:3] != k.shape[:3] or q.shape[4] != k.shape[3]:
        raise ValueError(f"flash attention: q [B,S,Hkv,G,D] and k/v "
                         f"[B,S,Hkv,D] expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    s = int(q.shape[1])
    qb, kvt = min(int(q_block), s), min(FLASH_MAX_TILE, s)
    if s % qb or s % kvt:
        raise ValueError(f"flash attention: sequence {s} must be a multiple "
                         f"of its q block {qb} and kv tile {kvt}")
    return qb


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_block: int, pos0: int) -> torch.Tensor:
    """K8's forward as one named op: the kernel on a CUDA tensor, the plain
    version on a CPU one."""
    qb = _flash_check(q, k, v, q_block)
    if _on_cpu(q):
        return ref.flash_attention(q, k, v, qb, pos0)
    b, s, hkv, g, d = (int(x) for x in q.shape)
    suffix = _SUFFIX.get(q.dtype)
    if suffix is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention: unsupported dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {d} not in "
                         f"{FLASH_HEAD_DIMS}")
    _check_tensors("flash_attention", q, k, v)
    out = torch.empty_like(q)
    _launch("flash_attention", f"flash_attention_{suffix}", q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, hkv, g, d,
            int(pos0))
    return out


@_flash_op.register_fake
def _flash_fake(q, k, v, q_block, pos0):
    # shapes only: a fake (or meta) tensor never builds or launches K8
    _flash_check(q, k, v, q_block)
    return torch.empty_like(q)


def _flash_setup(ctx, inputs, output) -> None:
    q, k, v, q_block, pos0 = inputs
    ctx.save_for_backward(q, k, v)
    ctx.q_block, ctx.pos0 = q_block, pos0


def _flash_backward(ctx, g):
    q, k, v = ctx.saved_tensors
    d_q, d_k, d_v = ref.flash_attention_vjp(q, k, v, g, ctx.q_block,
                                            ctx.pos0)
    return d_q, d_k, d_v, None, None


_flash_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_block: int = 512, pos0: int = 0) -> torch.Tensor:
    """Causal grouped-query attention, differentiable.

    q: [B, S, Hkv, G, D]; k/v: [B, S, Hkv, D] -> [B, S, Hkv, G, D].  As in
    the reference's kernel call, S must be a multiple of ``min(q_block, S)``
    and of ``min(512, S)``: any S up to 512, a multiple of 512 above.  One
    custom op, ``torch.ops.repro_torch.flash_attention``: its forward
    launches K8 on a CUDA tensor (f32 or bf16, D in ``FLASH_HEAD_DIMS``,
    every base pointer 16-byte aligned) or raises, runs the plain version
    on a CPU tensor, and under ``FakeTensorMode`` only gives the output's
    shape, so the dry-run, ``local_map`` and the cost model see one named
    op.  The gradient is the reference's recompute VJP
    (``ref.flash_attention_vjp``) on the inputs' device: it saves q, k and
    v, not the output.
    """
    return _flash_op(q, k, v, int(q_block), int(pos0))
