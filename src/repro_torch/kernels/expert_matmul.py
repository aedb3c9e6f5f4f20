"""Expert-gated grouped matmul (K3): the CUDA kernel's wrapper and its plain
version.

Replaces the Pallas TPU kernel ``src/repro/kernels/expert_matmul.py:
expert_matmul``.  ``out[e, c] = x[e, c] @ w[e]`` for ``c < counts[e]`` and
exact zeros for the rows past each expert's count, accumulated in fp32,
for bf16 or fp32 inputs.  The kernels (``csrc/expert_matmul.cu``) read
``counts`` from a device int32 tensor (the counterpart of scalar
prefetch), read no weight byte of an expert or tile with no rows, and read
x and w through their expert and row strides, so a sliced expert width
(``w[..., :a_ff]``) or expert count (``w[:a_experts]``) is a view of the
full resident weight, never a copy.

Three variants, chosen by :func:`choose_variant` from the call's shape,
dtype and strides (never from ``counts``, which stays on the device):
``stream`` (C <= 16: K1 small_m's weight streaming once per live expert,
split-K planned by :func:`stream_plan`, bf16 and fp32), ``tma`` (bf16 at
larger C: a grouped wgmma GEMM fed by TMA over 3-D tensor maps, in
:data:`TMA_TILE` blocks) and ``tile`` (the first port's 64x64 tile loop,
counted as ``tile_bf16`` or ``tile_f32``: fp32 at larger C, and bf16 whose
base or strides TMA cannot take).  The source note says what bounds each
on the H100 and what its design does about it.

``expert_matmul`` launches a kernel on CUDA tensors and raises on anything
it does not take; ``expert_matmul_plain`` is the same function in plain
PyTorch, used for CPU tensors and to hold the kernels against.

The backward (the reference has none: JAX differentiates through XLA) is
two more kernels that read the same device ``counts``:
``expert_matmul_dgrad`` (``dx[e, c] = dy[e, c] @ w[e]^T`` for ``c <
counts[e]``, exact zeros past it) and ``expert_matmul_wgrad`` (``dw[e] =
x[e, :counts[e]]^T @ dy[e, :counts[e]]`` over the live rows only, in w's
shape; a dead expert's dw is exactly zero and reads no byte of x or dy).
Rows of x and dy past a count never reach a live result, whatever they
hold.  The variants, chosen by :func:`choose_bwd_variant` from the kind,
dtype, shapes, bases and strides (never from ``counts``): ``persistent``
for bf16 TMA can read with at most 512 experts -- dgrad's with dx rows of
a multiple of 8: one block an SM walks a list of the live (expert, row
tile, column tile) items that it scans from the device counts, 128 x 256
tiles on wgmma, each tile stored by TMA while the next one loads, the
dead rows zeroed by the same blocks (:func:`dgrad_persistent_plan`);
wgrad's the same schedule over (live expert, 128-row K tile, 256-column
F tile) items, the experts by descending count (the longest reductions
first), each tile reduced over its
expert's live rows by one block, both operands MN-major
(:func:`wgrad_persistent_plan`) -- ``tma`` where ``persistent`` does not
take the call (dgrad: the forward's grouped wgmma GEMM with w as a
K-major B; wgrad: one 128 x 128 tile a block), ``tile_bf16`` and
``tile_f32`` (any strides, on FMAs: the stride-0 expert axis of the
dense oracle, fp32).  Plain versions sit beside them.
"""
from __future__ import annotations

import ctypes
import sys
import functools
import threading

import torch

from repro_torch.kernels import build, counting

# the wrappers run on several threads at once (two servers' collectors
# behind one arbiter): every count, read and reset of the counters
# below takes this lock, so no increment is lost
count_lock = threading.Lock()
_self = sys.modules[__name__]     # whose counters counting.count adds to
# kernel launches on the device since the last reset (the wrapper adds
# one per launch, a graph replay the launches it captured: counting.py),
# in all and by variant
launches = 0
VARIANTS = ("stream", "tma", "tile_bf16", "tile_f32")
variant_launches = dict.fromkeys(VARIANTS, 0)
# backward launches, by kernel and variant (one a call)
dgrad_launches = 0
wgrad_launches = 0
BWD_VARIANTS = ("persistent", "tma", "tile_bf16", "tile_f32")
dgrad_variant_launches = dict.fromkeys(BWD_VARIANTS, 0)
wgrad_variant_launches = dict.fromkeys(BWD_VARIANTS, 0)

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132               # streaming multiprocessors of an H100 SXM
STREAM_C_MAX = 16       # rows per expert the stream kernel takes
STREAM_BN = 64          # its output columns per block
STREAM_KC_MAX = 512     # its rows of x staged in shared memory
STREAM_KC_MIN = 256     # fewest weight rows worth a block of their own
# (rows, columns) of a tma block at every shape (the source's 64 * X_CWG
# and X_BN): at the LM's prefill it beat one block per (F tile, expert)
# over all its rows, 128 x 256 and two blocks per SM (PERF.md)
TMA_TILE = (128, 128)
# the persistent dgrad and wgrad: an item's rows (dx's, dw's K) and
# columns (128 measured slower at every train_4k shape, for both), and
# the most experts their prologues take
PERSISTENT_TILE = (128, 256)
PERSISTENT_E_MAX = 512

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_STRIDES = [_L, _I, _L, _I]          # x_se, x_sc, w_se, w_sk
_ARGTYPES = {
    "repro_expert_matmul": [_P] * 4 + [_I] * 4 + _STRIDES + [_I, _P],
    "repro_expert_matmul_stream": [_P] * 5 + [_I] * 4 + _STRIDES
    + [_I] * 4 + [_P],
    "repro_expert_matmul_tma": [_P] * 4 + [_I] * 4 + _STRIDES + [_P],
    "repro_expert_matmul_dgrad_tma": [_P] * 4 + [_I] * 4 + [_L, _I, _P],
    "repro_expert_matmul_wgrad_tma": [_P] * 4 + [_I] * 4 + [_L, _I, _P],
    "repro_expert_matmul_dgrad_persistent": [_P] * 4 + [_I] * 4
    + [_L, _I, _I, _P],
    "repro_expert_matmul_wgrad_persistent": [_P] * 4 + [_I] * 4
    + [_L, _I, _I, _P],
    "repro_expert_matmul_bwd_tile": [_I] + [_P] * 4 + [_I] * 4
    + [_L, _I, _I, _P],
}


def _launcher(name: str):
    fn = getattr(build.library("expert_matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def choose_variant(C: int, dtype: torch.dtype, strides: tuple,
                   aligned: bool) -> str:
    """The kernel a call goes to.  ``strides`` are (x_se, x_sc, w_se,
    w_sk) in elements as the kernel gets them (:func:`strides`),
    ``aligned`` whether x's and w's bases are 16-byte aligned and K >= 1
    (a tensor map has no empty dim).  TMA needs that and every stride a
    non-zero multiple of 16 bytes."""
    if C <= STREAM_C_MAX:
        return "stream"
    if dtype != torch.bfloat16:
        return "tile_f32"
    if aligned and all(s > 0 and s % 8 == 0 for s in strides):
        return "tma"
    return "tile_bf16"


@functools.lru_cache(maxsize=None)
def stream_plan(E: int, C: int, K: int, F: int, elem_bytes: int = 2
                ) -> tuple:
    """(splits, rows per split) of the stream kernel's K, from shapes
    alone (how many experts are live is on the device): enough blocks for
    ~4 per SM over the ``E * cdiv(F, 64)`` column tiles, no split under
    256 rows, none over the 512 rows of x a block stages, splits of even
    length; rows per split a multiple of the rows a block reads at once."""
    rows_at_once = 256 // (STREAM_BN // (16 // elem_bytes))
    if K <= 0 or F <= 0:
        return 1, rows_at_once
    tiles = E * _cdiv(F, STREAM_BN)
    splits = min(_cdiv(4 * SMS, tiles), max(1, K // STREAM_KC_MIN))
    splits = max(splits, _cdiv(K, STREAM_KC_MAX))
    kc = _cdiv(_cdiv(K, splits), rows_at_once) * rows_at_once
    return _cdiv(K, kc), kc


def check_args(x: torch.Tensor, w: torch.Tensor,
               counts: torch.Tensor) -> None:
    if x.ndim != 3 or w.ndim != 3:
        raise ValueError(f"want x (E, C, K) and w (E, K, F), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not match w "
                         f"{tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in DTYPE_CODES:
        raise TypeError(f"x and w must share a dtype in float32/bfloat16, "
                        f"got {x.dtype} and {w.dtype}")
    if counts.shape != (x.shape[0],) or counts.dtype != torch.int32:
        raise ValueError(f"counts must be int32 of shape ({x.shape[0]},), "
                         f"got {counts.dtype} {tuple(counts.shape)}")


def _dim_strides(t: torch.Tensor) -> tuple:
    """(stride of dim 0, stride of dim 1) of a 3-D tensor as the kernels
    get them.  A size-1 dim may carry any stride and the kernels never
    step it, but a tensor map needs a valid one there: the extent of the
    dims inside it (in the rows' own stride)."""
    n0, n1, n2 = t.shape
    s0, s1, _ = t.stride()
    if n1 <= 1:
        s1 = n2
    return (s0 if n0 > 1 else n1 * s1), s1


def strides(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """(x_se, x_sc, w_se, w_sk) in elements."""
    return _dim_strides(x) + _dim_strides(w)


def _plan(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """(variant, strides) of a call: what :func:`expert_matmul` launches,
    and the strides it passes."""
    st = strides(x, w)
    aligned = x.shape[2] > 0 and x.data_ptr() % 16 == 0 \
        and w.data_ptr() % 16 == 0
    return choose_variant(x.shape[1], x.dtype, st, aligned), st


def variant_of(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel :func:`expert_matmul` launches for x and w."""
    return _plan(x, w)[0]


def check_cuda_args(x: torch.Tensor, w: torch.Tensor,
                    counts: torch.Tensor) -> None:
    """Raise unless the kernels take x, w and counts as they are."""
    check_args(x, w, counts)
    dev = x.device
    if dev.type != "cuda" or w.device != dev or counts.device != dev:
        raise ValueError(f"expert_matmul needs x, w and counts on one CUDA "
                         f"device, got {dev}, {w.device}, {counts.device}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {dev} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if not counts.is_contiguous():
        raise ValueError("counts must be contiguous")
    if (x.shape[2] > 1 and x.stride(2) != 1) or \
            (w.shape[2] > 1 and w.stride(2) != 1):
        raise ValueError("x and w need a unit inner stride (row-major rows)")


def expert_matmul(x: torch.Tensor, w: torch.Tensor,
                  counts: torch.Tensor) -> torch.Tensor:
    """Launch a CUDA kernel: x (E, C, K) and w (E, K, F) with unit inner
    strides, ``counts`` a contiguous device int32 (E,) tensor."""
    check_cuda_args(x, w, counts)
    dev = x.device
    E, C, K = x.shape
    F = w.shape[2]
    y = torch.empty((E, C, F), dtype=x.dtype, device=dev)
    if y.numel() == 0:
        return y
    variant, st = _plan(x, w)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (x.data_ptr(), w.data_ptr(), y.data_ptr())
    if variant == "stream":
        splits, kc = stream_plan(E, C, K, F, x.element_size())
        ws = None if splits == 1 else torch.empty(
            (splits, E, C, F), dtype=torch.float32, device=dev)
        vec = 16 // x.element_size()
        vec_ok = w.data_ptr() % 16 == 0 and st[2] % vec == 0 \
            and st[3] % vec == 0
        rc = _launcher("repro_expert_matmul_stream")(
            *ptrs, None if ws is None else ws.data_ptr(), counts.data_ptr(),
            E, C, K, F, *st, splits, kc, int(vec_ok), DTYPE_CODES[x.dtype],
            stream)
    elif variant == "tma":
        rc = _launcher("repro_expert_matmul_tma")(
            *ptrs, counts.data_ptr(), E, C, K, F, *st, stream)
    else:
        rc = _launcher("repro_expert_matmul")(
            *ptrs, counts.data_ptr(), E, C, K, F, *st, DTYPE_CODES[x.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(f"expert_matmul ({variant}) launch failed "
                           f"(CUDA error {rc})")
    counting.count(_self, variant)
    return y


def expert_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                        counts: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: zero the rows at
    ``c >= counts[e]``, then one batched product."""
    check_args(x, w, counts)
    live = (torch.arange(x.shape[1], device=x.device)[None, :]
            < counts[:, None])
    xm = torch.where(live[..., None], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    return torch.bmm(xm, w)


# ------------------------------------------------------------------ backward


def choose_bwd_variant(F: int, dtype: torch.dtype, strides: tuple,
                       aligned: bool, kind: str = "dgrad", K: int = 8,
                       E: int = 1) -> str:
    """The backward kernel a ``kind`` ("dgrad" or "wgrad") call goes to.
    ``strides`` are the (expert, row) strides in elements of the operand
    read in place (w for dgrad, x for wgrad: dy and the outputs are
    contiguous), ``aligned`` whether every base is 16-byte aligned and K,
    F >= 1.  TMA needs that, every stride a non-zero multiple of 16 bytes
    and dy's rows of F a multiple of 8 elements.  Both ``persistent``
    kernels hold the ``E`` experts' counts in shared memory (at most
    :data:`PERSISTENT_E_MAX`), and dgrad's also stores dx's rows of ``K``
    by TMA (a multiple of 8); where they cannot, both take ``tma``."""
    if kind not in ("dgrad", "wgrad"):
        raise ValueError(f"kind must be dgrad or wgrad, got {kind!r}")
    if dtype != torch.bfloat16:
        return "tile_f32"
    if aligned and F % 8 == 0 and all(s > 0 and s % 8 == 0 for s in strides):
        if E <= PERSISTENT_E_MAX and (kind == "wgrad" or K % 8 == 0):
            return "persistent"
        return "tma"
    return "tile_bf16"


def dgrad_persistent_plan(E: int, C: int, K: int, sms: int = SMS) -> int:
    """Blocks of the persistent dgrad: one an SM, never more than the
    items all C rows of every expert would make (how many rows are live
    is on the device)."""
    bm, bn = PERSISTENT_TILE
    return max(1, min(sms, E * _cdiv(C, bm) * _cdiv(K, bn)))


def wgrad_persistent_plan(E: int, K: int, F: int, sms: int = SMS) -> int:
    """Blocks of the persistent wgrad: one an SM, never more than the
    (K tile, F tile) items every expert would make live (how many are
    live is on the device)."""
    bm, bn = PERSISTENT_TILE
    return max(1, min(sms, E * _cdiv(K, bm) * _cdiv(F, bn)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bwd_plan(a: torch.Tensor, dy: torch.Tensor, kind: str) -> tuple:
    """(variant, (expert, row) strides of ``a``) of a dgrad (``a`` = w)
    or wgrad (``a`` = x) call; its output is fresh, so 16-byte aligned."""
    st = _dim_strides(a)
    aligned = min(a.shape[1], a.shape[2], dy.shape[2]) > 0 and \
        a.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    return choose_bwd_variant(dy.shape[2], a.dtype, st, aligned, kind,
                              a.shape[1], a.shape[0]), st


def bwd_variant_of(a: torch.Tensor, dy: torch.Tensor,
                   kind: str = "dgrad") -> str:
    """The kernel :func:`expert_matmul_dgrad` (``a`` = w, ``kind``
    "dgrad") or :func:`expert_matmul_wgrad` (``a`` = x, "wgrad")
    launches for a contiguous ``dy``."""
    return _bwd_plan(a, dy, kind)[0]


def check_bwd_args(dy: torch.Tensor, a: torch.Tensor, counts: torch.Tensor,
                   dim: int) -> None:
    """dy (E, C, F) against w (E, K, F) (``dim`` 2) or x (E, C, K)
    (``dim`` 1)."""
    if dy.ndim != 3 or a.ndim != 3 or a.shape[0] != dy.shape[0] or \
            a.shape[dim] != dy.shape[dim]:
        raise ValueError(f"dy {tuple(dy.shape)} does not match "
                         f"{'w' if dim == 2 else 'x'} {tuple(a.shape)}")
    if dy.dtype != a.dtype or dy.dtype not in DTYPE_CODES:
        raise TypeError(f"dy and the operand must share a dtype in "
                        f"float32/bfloat16, got {dy.dtype} and {a.dtype}")
    E = dy.shape[0]
    if counts.shape != (E,) or counts.dtype != torch.int32:
        raise ValueError(f"counts must be int32 of shape ({E},), got "
                         f"{counts.dtype} {tuple(counts.shape)}")


def _check_bwd_cuda(a: torch.Tensor, dy: torch.Tensor,
                    counts: torch.Tensor) -> None:
    dev = dy.device
    if dev.type != "cuda" or a.device != dev or counts.device != dev:
        raise ValueError(f"expert_matmul backward needs dy, its operand and "
                         f"counts on one CUDA device, got {dev}, {a.device}, "
                         f"{counts.device}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {dev} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if not counts.is_contiguous():
        raise ValueError("counts must be contiguous")
    if a.shape[2] > 1 and a.stride(2) != 1:
        raise ValueError("the operand needs a unit inner stride")


def _bwd_launch(op: int, a: torch.Tensor, dy: torch.Tensor,
                out: torch.Tensor, counts: torch.Tensor, K: int) -> str:
    """Launch dgrad (op 0, a = w) or wgrad (op 1, a = x) into ``out``;
    returns the variant."""
    variant, st = _bwd_plan(a, dy, "dgrad" if op == 0 else "wgrad")
    E, C, F = dy.shape
    stream = torch.cuda.current_stream(dy.device).cuda_stream
    if variant == "persistent" and op == 0:
        grid = dgrad_persistent_plan(E, C, K, _sm_count(dy.device.index))
        rc = _launcher("repro_expert_matmul_dgrad_persistent")(
            dy.data_ptr(), a.data_ptr(), out.data_ptr(), counts.data_ptr(),
            E, C, K, F, *st, grid, stream)
    elif variant == "persistent":
        grid = wgrad_persistent_plan(E, K, F, _sm_count(dy.device.index))
        rc = _launcher("repro_expert_matmul_wgrad_persistent")(
            a.data_ptr(), dy.data_ptr(), out.data_ptr(), counts.data_ptr(),
            E, C, K, F, *st, grid, stream)
    elif variant == "tma":
        name = ("repro_expert_matmul_dgrad_tma" if op == 0
                else "repro_expert_matmul_wgrad_tma")
        if op == 0:
            rc = _launcher(name)(dy.data_ptr(), a.data_ptr(), out.data_ptr(),
                                 counts.data_ptr(), E, C, K, F, *st, stream)
        else:
            rc = _launcher(name)(a.data_ptr(), dy.data_ptr(), out.data_ptr(),
                                 counts.data_ptr(), E, C, K, F, *st, stream)
    else:
        rc = _launcher("repro_expert_matmul_bwd_tile")(
            op, a.data_ptr(), dy.data_ptr(), out.data_ptr(),
            counts.data_ptr(), E, C, K, F, *st, DTYPE_CODES[a.dtype], stream)
    if rc != 0:
        kind = "dgrad" if op == 0 else "wgrad"
        raise RuntimeError(f"expert_matmul_{kind} ({variant}) launch failed "
                           f"(CUDA error {rc})")
    return variant


def expert_matmul_dgrad(dy: torch.Tensor, w: torch.Tensor,
                        counts: torch.Tensor) -> torch.Tensor:
    """Launch the dgrad kernel: dy (E, C, F) and w (E, K, F) -> dx (E, C,
    K), ``dx[e, c] = dy[e, c] @ w[e]^T`` for ``c < counts[e]`` and exact
    zeros past it.  ``w`` may be a strided view (unit inner stride); dy is
    made contiguous."""
    check_bwd_args(dy, w, counts, 2)
    _check_bwd_cuda(w, dy, counts)
    E, K, F = w.shape
    dy = dy.contiguous()
    C = dy.shape[1]
    dx = torch.empty((E, C, K), dtype=dy.dtype, device=dy.device)
    if dx.numel() == 0:
        return dx
    if F == 0:
        return dx.zero_()
    variant = _bwd_launch(0, w, dy, dx, counts, K)
    counting.count(_self, variant, "dgrad_launches", "dgrad_variant_launches")
    return dx


def expert_matmul_wgrad(x: torch.Tensor, dy: torch.Tensor,
                        counts: torch.Tensor) -> torch.Tensor:
    """Launch the wgrad kernel: x (E, C, K) and dy (E, C, F) -> dw (E, K,
    F) (the shape of the forward's w), ``dw[e] = x[e, :counts[e]]^T @
    dy[e, :counts[e]]``; a dead expert's dw is exactly zero.  ``x`` may be
    strided (unit inner stride); dy is made contiguous."""
    check_bwd_args(dy, x, counts, 1)
    _check_bwd_cuda(x, dy, counts)
    E, C, K = x.shape
    dy = dy.contiguous()
    F = dy.shape[2]
    dw = torch.empty((E, K, F), dtype=dy.dtype, device=dy.device)
    if dw.numel() == 0:
        return dw
    if C == 0:
        return dw.zero_()
    variant = _bwd_launch(1, x, dy, dw, counts, K)
    counting.count(_self, variant, "wgrad_launches", "wgrad_variant_launches")
    return dw


def _live_rows(t: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """t (E, C, n) with the rows at ``c >= counts[e]`` replaced by zeros
    (a select: whatever they held never reaches the result)."""
    live = (torch.arange(t.shape[1], device=t.device)[None, :]
            < counts[:, None])
    return torch.where(live[..., None], t,
                       torch.zeros((), dtype=t.dtype, device=t.device))


def expert_matmul_dgrad_plain(dy: torch.Tensor, w: torch.Tensor,
                              counts: torch.Tensor) -> torch.Tensor:
    """The dgrad in plain PyTorch: the live rows of dy times w^T."""
    check_bwd_args(dy, w, counts, 2)
    return torch.bmm(_live_rows(dy, counts), w.transpose(1, 2))


def expert_matmul_wgrad_plain(x: torch.Tensor, dy: torch.Tensor,
                              counts: torch.Tensor) -> torch.Tensor:
    """The wgrad in plain PyTorch: x^T times dy over the live rows."""
    check_bwd_args(dy, x, counts, 1)
    return torch.bmm(_live_rows(x, counts).transpose(1, 2),
                     _live_rows(dy, counts))
