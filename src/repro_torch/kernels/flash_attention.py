"""Flash attention (K2): the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py:
flash_attention``: blocked online-softmax attention with the running max,
denominator and accumulator in fp32, causal or not.  The kernel
(``csrc/flash_attention.cu``) masks keys at positions >= T (the reference
wrapper's zero-padded keys enter the softmax: fault F1 in ROADMAP.md),
picks the kv head as ``h // (H // KH)`` (no repeated k/v copy) and reads
and writes through (batch, seq, head) strides.

Four variants, chosen by :func:`choose_variant` from the shapes alone:
``wgmma`` (bf16 at head dims 64, 112 and 128, S >= ``WGMMA_FWD_MIN_S``:
FlashAttention-3's forward, a persistent block an SM planned by
:func:`wgmma_fwd_plan`, a producer thread streaming K and V by TMA, two
consumer warpgroups of 64 query rows on wgmma; every prefill, training
and serving call of the port but the UNet's 8 x 8 latent), ``mma`` (the
same dims on mma.sync, at S <= 64, where it measured faster), ``decode``
(the same at S = 1, any number of query heads a kv head, in groups of up
to 8 a block: split over T, partials merged by a second kernel, the
split planned by :func:`decode_plan` from the cache's capacity, the count
of valid keys read from a device int32: ``kv_len``, the decode cache's
fill, so one CUDA graph of a decode step serves every step) and ``fma``
(the first port's fp32
FMA kernel, counted as ``fma_bf16`` or ``fma_f32``: fp32 inputs, the smoke
configs' head dims 8 and 16, and rows that are not 16-byte aligned; every
head dim of ``HEAD_DIMS``).  The source note says what bounds each on the
H100 and what its design does about it.

Layout at this level: q (B, S, H, D), k/v (B, T, KH, D) -> o (B, S, H, D).
``kv_len`` (a 0-d int32 tensor on the device, >= 0) masks the keys at or
past it, as the reference's ``kv_len`` mask of a decode step; the other
variants read it on the host (a device sync: eager only, never inside a
CUDA graph capture).  A row with no valid key (``kv_len`` 0: a shard of
a sequence-sharded cache that holds none yet) gives o = 0.
``flash_attention`` launches the kernel on CUDA tensors;
``flash_attention_plain`` is the same function in plain PyTorch.  With
``return_lse`` both also give each row's fp32 logsumexp (B, H, S) of the
scaled scores (-inf for a row with no valid key), which the backward
reads and which a sequence-sharded decode
(``distributed/decode_attn.py``) merges across shards.

The backward (the reference has none: JAX differentiates through XLA)
is ``flash_attention_bwd``, causal or not, at D = 64, 112 (kimi-k2) and
128 in bf16 and 8, 16 and 64 in fp32, in three variants chosen by
:func:`choose_bwd_variant` from shapes and dtype: ``resident`` (bf16,
non-causal, D = 64, S, T <= 256, the sandwich step's S = T = 197: one
block per (batch, kv head) holds its keys and makes one pass on wgmma,
each input read once, dQ from dS in the same block), ``wgmma`` (every
other bf16 call, the LMs' causal S = T = 4096 at D = 128 and 112 among
them:
FlashAttention-3's backward, one block per 128-key tile fed by TMA, one
pass of five products on wgmma, dQ added into an fp32 workspace in
key-tile order behind per-chunk tickets, so deterministic, then cast
into dq by a second kernel) and ``fma_f32`` (fp32 on FMAs: a delta
pre-pass, then dK/dV and dQ in two passes); any other head dim raises
``NotImplementedError``.
``flash_attention_bwd_plain`` is the same gradient as
explicit formulas, for CPU tensors and to hold the kernel against.
"""
from __future__ import annotations

import ctypes
import sys
import math
import threading
from typing import Optional

import torch

from repro_torch.kernels import build, counting
from repro_torch.kernels.ref import flash_attention_ref

# the wrappers run on several threads at once (two servers' collectors
# behind one arbiter): every count, read and reset of the counters
# below takes this lock, so no increment is lost
count_lock = threading.Lock()
_self = sys.modules[__name__]     # whose counters counting.count adds to
# kernel launches on the device since the last reset (the wrapper adds
# one per launch, a graph replay the launches it captured: counting.py),
# in all and by variant
launches = 0
VARIANTS = ("wgmma", "mma", "decode", "fma_bf16", "fma_f32")
variant_launches = dict.fromkeys(VARIANTS, 0)
# backward launches (one a call, whatever kernels the variant runs)
bwd_launches = 0
BWD_VARIANTS = ("wgmma", "resident", "fma_f32")
bwd_variant_launches = dict.fromkeys(BWD_VARIANTS, 0)
BWD_HEAD_DIMS = (64, 112, 128)  # bf16: the ViTs', kimi-k2's, the LMs'
# fp32: the smoke configs' 8 and 16 too (the fp32 kernel's tiles and
# registers cannot take 112 or 128: the source note)
BWD_F32_HEAD_DIMS = (8, 16, 64)
RESIDENT_MAX = 256      # queries and keys of a head the resident kernel takes
WGMMA_KEYS = 128        # keys a block of the wgmma backward (its key tile)
WGMMA_CHUNK = 64        # queries a chunk (one dQ ticket each)

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# ViTs (64), their smoke configs, the LMs (128; kimi-k2's 112)
HEAD_DIMS = (8, 16, 64, 112, 128)
MMA_HEAD_DIMS = (64, 112, 128)      # the wgmma forward's too
WGMMA_FWD_ROWS = 128    # query rows a tile of the wgmma forward (2 x 64)
WGMMA_FWD_KEYS = 128    # keys a K or V tile it streams
# the fewest query rows a call takes the wgmma forward at: with fewer, half
# or more of its 128-row tile is padding, and at the UNet's 8 x 8 latent
# (S = 64, self- and cross-attention) mma measured faster; at every other
# call class of the port (S = 197 to 4096) wgmma did (PERF.md, chip_smoke
# phase 27 (b))
WGMMA_FWD_MIN_S = 65
# the K and V bytes of a group of (batch, head) pairs whose causal tiles the
# wgmma forward takes together (of the H100's 50 MB of L2)
WGMMA_FWD_L2_BYTES = 32 << 20
SMS = 132                     # streaming multiprocessors of an H100 SXM
DECODE_R_MAX = 8              # query heads a decode block takes (a group)
DECODE_CHUNK_MAX = 256        # keys per decode block (its shared scores)
DECODE_CHUNK_MIN = 32         # fewest keys worth a block of their own

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_ARGTYPES = {
    "repro_flash_attention": [_P] * 4 + [_I] * 6 + [_STRIDES, _F, _I, _I,
                                                    _P, _P],
    "repro_flash_attention_mma": [_P] * 4 + [_I] * 6 + [_STRIDES, _F, _I,
                                                        _P, _P],
    "repro_flash_attention_wgmma": [_P] * 4 + [_I] * 6 + [_STRIDES, _F, _I,
                                                          _P, _I, _I, _I,
                                                          _P, _P],
    "repro_flash_attention_bwd": [_P] * 10 + [_I] * 6 + [_STRIDES, _F, _I,
                                                         _I, _P],
    "repro_flash_attention_decode_len": [_P] * 6 + [_I] * 5 + [_STRIDES, _F,
                                                               _I, _I, _P],
    "repro_flash_attention_decode_lse": [_P] * 7 + [_I] * 5 + [_STRIDES, _F,
                                                               _I, _I, _P],
    "repro_flash_attention_bwd_resident": [_P] * 9 + [_I] * 6 + [_STRIDES,
                                                                 _F, _P],
    "repro_flash_attention_bwd_wgmma": [_P] * 11 + [_I] * 6 + [_STRIDES, _F,
                                                              _I, _P],
}


def _launcher(name: str):
    fn = getattr(build.library("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def choose_variant(S: int, T: int, H: int, KH: int, D: int,
                   dtype: torch.dtype, aligned: bool) -> str:
    """The kernel a call goes to.  ``T`` counts the keys a query may see
    (at S = 1 and causal, at most one); ``aligned`` whether every q/k/v
    base and (batch, seq, head) stride is a multiple of 16 bytes."""
    if dtype != torch.bfloat16:
        return "fma_f32"
    if D not in MMA_HEAD_DIMS or not aligned:
        return "fma_bf16"
    if S == 1 and T >= 1:
        return "decode"
    if T >= 1 and S >= WGMMA_FWD_MIN_S:
        return "wgmma"
    return "mma"


def wgmma_fwd_plan(B: int, H: int, KH: int, S: int, T: int, D: int,
                   causal: bool, sms: int = SMS) -> tuple:
    """(blocks, query tiles, group, dynamic) of the wgmma forward: one
    persistent block an SM, never more blocks than the B * H * ceil(S /
    128) tiles.  Causal, ``group`` (batch, head) pairs whose K and V (4 T D
    bytes a kv head, shared by H / KH query heads) fit in
    ``WGMMA_FWD_L2_BYTES`` together are the schedule's unit (all B * H
    otherwise).  ``dynamic``: the blocks take tiles from a counter, as
    measured faster for non-causal calls and for causal ones whose K and
    V outgrow that (train_4k); causal calls whose K and V fit at once
    (the 512-token prefills) are dealt by :func:`wgmma_fwd_block_tiles`
    instead (PERF.md)."""
    tiles = B * H * _cdiv(S, WGMMA_FWD_ROWS)
    group = B * H
    if causal:
        group = max(1, min(B * H, WGMMA_FWD_L2_BYTES * (H // KH)
                           // max(4 * T * D, 1)))
    return min(tiles, sms), tiles, group, not causal or group < B * H


def wgmma_fwd_block_tiles(x: int, blocks: int, tiles: int) -> list:
    """The tiles block ``x`` takes when the plan is not dynamic, as the
    kernel's producer deals them: rounds of ``blocks`` tiles in schedule
    order, taken left to right and right to left in turn (the longest
    causal tiles first, and the block that took a round's shortest takes
    the next round's longest, so the blocks' work comes out even)."""
    out = []
    for r in range(_cdiv(tiles, blocks)):
        t = r * blocks + (x if r % 2 == 0 else blocks - 1 - x)
        if t >= tiles:
            break
        out.append(t)
    return out


def wgmma_fwd_tile(t: int, B: int, H: int, S: int, causal: bool,
                   group: int) -> tuple:
    """(batch, head, query tile) of tile ``t`` of the wgmma forward's
    schedule, as the kernel's ``fwd_tile`` computes it (the blocks take
    its tiles from a counter, or as :func:`wgmma_fwd_block_tiles` deals
    them: see :func:`wgmma_fwd_plan`).  Causal: the (batch, head)
    pairs in groups of ``group``, and within a group the query tiles that
    see the most keys first, its heads fastest (the group's K and V stay
    in L2 while its tiles run); otherwise a head's query tiles one after
    another, so that they share its K and V in L2."""
    BH, nq = B * H, _cdiv(S, WGMMA_FWD_ROWS)
    if causal:
        g, i = divmod(t, group * nq)
        gh = min(group, BH - g * group)
        bh, qt = g * group + i % gh, nq - 1 - i // gh
    else:
        bh, qt = t // nq, t % nq
    return bh // H, bh % H, qt


_sm_counts: dict = {}


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (cached per device)."""
    n = _sm_counts.get(device)
    if n is None:
        n = _sm_counts[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def decode_groups(H: int, KH: int) -> int:
    """Decode blocks a (batch, kv head) and split: one per group of up to
    ``DECODE_R_MAX`` of its H / KH query heads (granite-20b's 48: 6)."""
    return _cdiv(H // KH, DECODE_R_MAX)


def decode_plan(T: int, bkh: int, sms: int = SMS) -> tuple:
    """(splits, keys per split) of the decode kernel over ``bkh`` = B*KH*
    :func:`decode_groups` blocks a split: ~2 blocks per SM, no split under
    32 keys, none over the 256 keys whose scores a block keeps in shared
    memory.  ``T`` is the cache's capacity: a split past the fill exits at
    once."""
    splits = min(_cdiv(2 * sms, bkh), _cdiv(T, DECODE_CHUNK_MIN))
    splits = max(splits, _cdiv(T, DECODE_CHUNK_MAX), 1)
    chunk = _cdiv(T, splits)
    return _cdiv(T, chunk), chunk


_lengths: dict = {}
_lengths_lock = threading.Lock()


def length_tensor(device: torch.device, n: int) -> torch.Tensor:
    """A device int32 holding ``n``, cached per (device, n): the decode
    kernel's key count when the caller gives no ``kv_len``.  Made at a
    call's first eager run: creating it inside a graph capture raises."""
    key = (device, n)
    with _lengths_lock:
        t = _lengths.get(key)
        if t is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("flash_attention: a key-count tensor "
                                   "would be made inside a CUDA graph "
                                   "capture: run the call eagerly first")
            t = torch.full((), n, dtype=torch.int32, device=device)
            _lengths[key] = t
        return t


def check_kv_len(kv_len: torch.Tensor, k: torch.Tensor) -> None:
    if kv_len.dtype != torch.int32 or kv_len.numel() != 1 \
            or kv_len.device != k.device:
        raise ValueError(f"kv_len must be one int32 on {k.device}, got "
                         f"{kv_len.dtype} {tuple(kv_len.shape)} on "
                         f"{kv_len.device}")


def _host_len(kv_len: torch.Tensor) -> int:
    """The key count read on the host (a device sync): for the variants
    that take it as an argument; never inside a capture."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("flash_attention: only the decode variant reads "
                           "kv_len on the device; this call would read it "
                           "on the host inside a CUDA graph capture")
    return int(kv_len)


def _aligned(*ts: torch.Tensor) -> bool:
    # a size-1 dim may carry any stride; the kernels never step it
    return all(t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)
        for t in ts)


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,H,D), k/v (B,T,KH,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (H must be a multiple of KH)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(f"q, k, v must share a dtype in float32/bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, return_lse: bool = False,
                    kv_len: Optional[torch.Tensor] = None):
    """Launch the CUDA kernel (inputs may be strided; head dim contiguous).
    Returns o, or (o, lse) with ``return_lse`` (at decode, S = 1, written
    by the merge kernel).  ``kv_len``: the count of valid keys (see the
    module note)."""
    check_args(q, k, v)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention needs q, k, v on one CUDA device, "
                         f"got {dev}, {k.device}, {v.device}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {dev} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a contiguous head dim")
    T_seen = min(T, 1) if causal and S == 1 else T
    variant = choose_variant(S, T_seen, H, KH, D, q.dtype,
                             _aligned(q, k, v))
    if kv_len is not None:
        check_kv_len(kv_len, k)
        if variant != "decode":
            n = _host_len(kv_len)
            return flash_attention(q, k[:, :n], v[:, :n], causal=causal,
                                   return_lse=return_lse)
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev) \
        if return_lse else None
    if B * H * S == 0:
        return (o, lse) if return_lse else o
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3]))
    scale = 1.0 / math.sqrt(D)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    lse_ptr = None if lse is None else lse.data_ptr()
    if variant == "decode":
        # causal at S = 1 sees key 0 alone, whatever the fill
        n = kv_len if kv_len is not None and T_seen == T \
            else length_tensor(dev, T_seen)
        splits, chunk = decode_plan(T_seen, B * KH * decode_groups(H, KH))
        ws = torch.empty(B * H * splits * (D + 2), dtype=torch.float32,
                         device=dev)
        # the lse entry point only when asked: a library built before it
        # (a parent's) has the other
        tail = (B, H, KH, T_seen, D, strides, scale, splits, chunk, stream)
        if return_lse:
            rc = _launcher("repro_flash_attention_decode_lse")(
                *ptrs, ws.data_ptr(), n.data_ptr(), lse_ptr, *tail)
        else:
            rc = _launcher("repro_flash_attention_decode_len")(
                *ptrs, ws.data_ptr(), n.data_ptr(), *tail)
    elif variant == "wgmma":
        blocks, _, group, dynamic = wgmma_fwd_plan(B, H, KH, S, T, D,
                                                   causal, sm_count(dev))
        # the tile counter (read only when dynamic), held until launched
        counter = torch.zeros(1, dtype=torch.int32, device=dev) \
            if dynamic else None
        rc = _launcher("repro_flash_attention_wgmma")(
            *ptrs, B, H, KH, S, T, D, strides, scale, int(causal), lse_ptr,
            blocks, group, int(dynamic),
            counter.data_ptr() if dynamic else None, stream)
    elif variant == "mma":
        rc = _launcher("repro_flash_attention_mma")(
            *ptrs, B, H, KH, S, T, D, strides, scale, int(causal), lse_ptr,
            stream)
    else:
        rc = _launcher("repro_flash_attention")(
            *ptrs, B, H, KH, S, T, D, strides, scale, int(causal),
            DTYPE_CODES[q.dtype], lse_ptr, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention ({variant}) launch failed "
                           f"(CUDA error {rc})")
    counting.count(_self, variant)
    return (o, lse) if return_lse else o


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, return_lse: bool = False,
                          kv_len: Optional[torch.Tensor] = None):
    """The same function in plain PyTorch: repeat kv heads for GQA, then
    the naive oracle over (B*H, S, D), the keys at or past ``kv_len``
    masked on the device (no host read; o = 0 where none is valid); with
    ``return_lse`` also each row's logsumexp of the scaled scores, fp32
    (B, H, S), -inf where no key is valid."""
    check_args(q, k, v)
    if kv_len is not None:
        check_kv_len(kv_len, k)
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    if KH != H:
        k = k.repeat_interleave(H // KH, dim=2)
        v = v.repeat_interleave(H // KH, dim=2)
    qf = q.transpose(1, 2).reshape(B * H, S, D)
    kf = k.transpose(1, 2).reshape(B * H, T, D)
    vf = v.transpose(1, 2).reshape(B * H, T, D)
    o = flash_attention_ref(qf, kf, vf, causal=causal,
                            kv_len=None if kv_len is None
                            else kv_len.reshape(()))
    o = o.reshape(B, H, S, D).transpose(1, 2)
    if kv_len is not None:      # no valid key: 0, not the mean of v
        o = o * (kv_len.reshape(()) > 0).to(o.dtype)
    if not return_lse:
        return o
    s = _scores(q, k, causal)
    if kv_len is not None:
        live = torch.arange(T, device=q.device) < kv_len.reshape(())
        s = s.masked_fill(~live, float("-inf"))
    return o, torch.logsumexp(s, -1)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """fp32 scaled scores (B, H, S, T) of q and the kv heads repeated to
    H; masked (causal) entries are -inf."""
    S, T, D = q.shape[1], k.shape[1], q.shape[3]
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(D)
    if causal:
        keep = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(T, device=q.device)[None, :])
        s = s.masked_fill(~keep, float("-inf"))
    return s


def choose_bwd_variant(S: int, T: int, D: int, dtype: torch.dtype,
                       causal: bool) -> str:
    """The backward kernel a call goes to, from shapes and dtype (the
    wrapper copies rows the kernels cannot read with 16-byte loads or TMA
    first); raises ``NotImplementedError`` for what no kernel takes (D
    other than 64, 112 or 128 in bf16, other than 8, 16 or 64 in fp32).
    ``resident`` (non-causal, D = 64) holds a head's keys in shared memory
    (T <= 256) and walks its queries serially in one block per (batch, kv
    head); every other bf16 call -- causal, D = 128, or S or T past 256 --
    takes ``wgmma`` (kimi-k2's D = 112 too), whose grid also runs over
    128-key tiles and which
    skips the causal mask's dead chunks.  With few (batch, kv head) blocks
    the serial walk costs too: at B * KH = 22 on an H100 (132 SMs)
    ``resident`` took 34-35 us a call at S = T = 197 against 27.5 us for
    the two-pass mma.sync backward it replaced (PERF.md, open
    questions).  No caller sends so few heads
    today, so the choice does not look at B * KH."""
    dims = BWD_HEAD_DIMS if dtype == torch.bfloat16 else BWD_F32_HEAD_DIMS
    if D not in dims:
        raise NotImplementedError(
            f"flash_attention backward: D={D}, {dtype}; the kernels take "
            f"D in {BWD_HEAD_DIMS} in bf16 and {BWD_F32_HEAD_DIMS} in fp32")
    if dtype != torch.bfloat16:
        return "fma_f32"
    if not causal and D == 64 and 1 <= S <= RESIDENT_MAX \
            and 1 <= T <= RESIDENT_MAX:
        return "resident"
    return "wgmma"


def wgmma_plan(B: int, H: int, KH: int, S: int, T: int) -> tuple:
    """(blocks, rows of the fp32 dQ workspace, tickets) of the wgmma
    backward: a block per (128-key tile, batch, kv head); the workspace
    (B, H, S, D) that the key tiles add dQ into in order, one int32
    ticket per (batch, head, chunk of 64 queries) for that order."""
    return (B * KH * _cdiv(T, WGMMA_KEYS), B * H * S,
            B * H * _cdiv(S, WGMMA_CHUNK))


def check_bwd_args(q, k, v, o, do) -> None:
    check_args(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if not (o.dtype == do.dtype == q.dtype):
        raise TypeError(f"o and do must be {q.dtype}, got {o.dtype}, "
                        f"{do.dtype}")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool) -> tuple:
    """Launch the backward kernels: (dq, dk, dv) in q's, k's and v's
    shapes, from the forward's o and fp32 logsumexp ``lse`` (B, H, S) and
    the output gradient ``do``, causal or not, at the head dims
    :func:`choose_bwd_variant` takes."""
    check_bwd_args(q, k, v, o, do)
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    variant = choose_bwd_variant(S, T, D, q.dtype, causal)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, o, do,
                                                           lse)):
        raise ValueError("flash_attention_bwd needs every tensor on one "
                         "CUDA device")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 {(B, H, S)}")
    # the kernels read rows with 16-byte loads or TMA: copy anything else
    # into fresh storage (contiguous() keeps a contiguous view's unaligned
    # base)
    q, k, v, o, do = (t if t.stride(3) == 1 and _aligned(t)
                      else t.clone(memory_format=torch.contiguous_format)
                      for t in (q, k, v, o, do))
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    dk = torch.empty((B, T, KH, D), dtype=q.dtype, device=dev)
    dv = torch.empty((B, T, KH, D), dtype=q.dtype, device=dev)
    if B * H * S == 0 or T == 0:
        return dq, dk.zero_(), dv.zero_()
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if variant == "resident":
        rc = _launcher("repro_flash_attention_bwd_resident")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, KH, S, T, D, strides, 1.0 / math.sqrt(D),
            stream)
    elif variant == "wgmma":
        _, ws_rows, n_tickets = wgmma_plan(B, H, KH, S, T)
        ws = torch.empty((ws_rows, D), dtype=torch.float32, device=dev)
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=dev)
        rc = _launcher("repro_flash_attention_bwd_wgmma")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), ws.data_ptr(),
            tickets.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, KH, S, T, D, strides,
            1.0 / math.sqrt(D), int(causal), stream)
    else:                                    # fma_f32
        delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        rc = _launcher("repro_flash_attention_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, KH, S, T, D, strides,
            1.0 / math.sqrt(D), int(causal), DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward ({variant}) launch "
                           f"failed (CUDA error {rc})")
    counting.count(_self, variant, "bwd_launches",
                   "bwd_variant_launches")
    return dq, dk, dv


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, *, causal: bool) -> tuple:
    """The backward as explicit formulas in fp32 (P from the scores, not
    from a saved logsumexp): dV = P^T dO, dS = P (dO V^T - rowsum(dO o)),
    dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D), GQA's kv-head gradients
    summed over the query heads that share them; cast to the inputs'
    dtype."""
    check_bwd_args(q, k, v, o, do)
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    R = H // KH
    kr = k.repeat_interleave(R, dim=2) if R > 1 else k
    vr = v.repeat_interleave(R, dim=2) if R > 1 else v
    p = torch.softmax(_scores(q, kr, causal), -1)        # (B, H, S, T)
    dof, vf = do.float(), vr.float()
    dv = torch.einsum("bhst,bshd->bthd", p, dof)
    dp = torch.einsum("bshd,bthd->bhst", dof, vf)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)    # (B, H, S)
    ds = p * (dp - delta[..., None]) / math.sqrt(D)
    dq = torch.einsum("bhst,bthd->bshd", ds, kr.float())
    dk = torch.einsum("bhst,bshd->bthd", ds, q.float())
    if R > 1:
        dk = dk.reshape(B, T, KH, R, D).sum(3)
        dv = dv.reshape(B, T, KH, R, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
