"""Width-elastic matmul (K1): the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``src/repro/kernels/elastic_matmul.py:
elastic_matmul``.  ``y[m, n] = sum_{k<k_act} x[m, k] w[k, n]`` for
``n < n_act`` and exact zeros for ``n_act <= n < n_out``, accumulated in
fp32, for bf16 or fp32 inputs.  The kernels (``csrc/elastic_matmul.cu``)
read the widths from a device int32[2] (the counterpart of scalar
prefetch) and the active block of the FULL resident weight through its row
stride, so no call copies ``w[:k_act, :n_act]``.

Four variants, chosen by :func:`choose_variant` from the call's shape,
dtype and strides: ``small_m`` (M <= 16: a weight-streaming split-K
kernel, bf16 and fp32), ``tma`` (bf16 at larger M: a wgmma GEMM fed by
TMA), ``f32_splitk`` (fp32 at larger M with 16-byte loads: the MoE
router at prefill; a split-K FMA GEMM planned by :func:`f32_splitk_plan`
to fill the card, its reduce fused by per-tile tickets) and ``tile``
(the first port's 64x64 tile loop, counted as ``tile_bf16`` or
``tile_f32``: fp32 rows that forbid 16-byte loads, and bf16 whose bases
or row strides TMA cannot take).  The source note says what bounds each
on the H100 and what its design does about it.

``elastic_matmul`` launches a kernel on CUDA tensors and raises on
anything it does not take; ``elastic_matmul_plain`` is the same function in
plain PyTorch, used for CPU tensors and to hold the kernels against.

The backward (the reference has none: JAX differentiates through XLA) is
two more kernels that read the same device widths: ``elastic_matmul_dgrad``
(``dx = dy[:, :n_act] @ w[:k_act, :n_act]^T``, zeros past k_act) and
``elastic_matmul_wgrad`` (``dw = x[:, :k_act]^T @ dy[:, :n_act]`` on the
active block, zeros elsewhere in the full weight's shape, split over M),
with plain versions beside them.  Three variants each, chosen by
:func:`choose_bwd_variant` from dtype, bases and strides: ``tma`` (bf16
that TMA can read: the forward's wgmma ring; dgrad persistent with a
K-major B and a TMA store, wgrad with an MN-major A, M split by
:func:`wgrad_tma_plan` into one wave of blocks and the split-K reduce
fused into the kernel), ``wmma_bf16`` (bf16 that TMA cannot read: a WMMA
tile GEMM, wgrad split by :func:`wgrad_plan` with a second pass that adds
the partials in order) and ``fma_f32`` (fp32).  The source note says what
bounds them and what the design does about it.
"""
from __future__ import annotations

import ctypes
import sys
import threading
from typing import Dict, Optional

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
VARIANTS = ("small_m", "tma", "f32_splitk", "tile_bf16", "tile_f32")
variant_launches = dict.fromkeys(VARIANTS, 0)
# backward launches, by kernel and variant (one a call)
dgrad_launches = 0
wgrad_launches = 0
BWD_VARIANTS = ("tma", "wmma_bf16", "fma_f32")
dgrad_variant_launches = dict.fromkeys(BWD_VARIANTS, 0)
wgrad_variant_launches = dict.fromkeys(BWD_VARIANTS, 0)
BWD_TILE = 128          # the wgrad workspace's padding (the bf16 tile)
WGRAD_ROWS_MIN = 256    # fewest rows of M worth a split of their own
# the tma backward kernels' tile (rows, columns) and wgrad's most splits
# (wgrad_tma_plan; sweep_splits.py times the alternatives, PERF.md)
BWD_TMA_TILE = (128, 128)
WGRAD_TMA_SPLITS_MAX = 14
TMA_BOX = 64            # rows of a TMA box: wgrad's chunks are whole boxes
TILE_COUNTERS = 1 << 16  # tma wgrad's and f32_splitk's tickets, per device
# the f32_splitk kernel's tile rows and columns, rows of K a stage, fewest
# rows of K worth a split, most splits, and blocks an SM holds at once
# (f32_splitk_plan; sweep_splits.py times the alternatives, PERF.md)
F32_SPLITK_BM = 64
F32_SPLITK_BN = 64
F32_SPLITK_BK = 16
F32_SPLITK_KC_MIN = 128
F32_SPLITK_SPLITS_MAX = 16
F32_SPLITK_BLOCKS_PER_SM = 2

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132               # streaming multiprocessors of an H100 SXM
SMALL_M_MAX = 16        # rows the small_m kernel takes (its register tile)
SMALL_M_BN = 64         # its output columns per block
SMALL_M_KC_MAX = 512    # its rows of x staged in shared memory
SMALL_M_KC_MIN = 256    # fewest weight rows worth a block of their own

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "repro_elastic_matmul": [_P] * 4 + [_I] * 6 + [_P],
    "repro_elastic_matmul_small_m": [_P] * 5 + [_I] * 10 + [_P],
    "repro_elastic_matmul_tma": [_P] * 4 + [_I] * 9 + [_P],
    "repro_elastic_matmul_f32_splitk": [_P] * 6 + [_I] * 9 + [_P],
    "repro_elastic_matmul_dgrad": [_P] * 4 + [_I] * 7 + [_P],
    "repro_elastic_matmul_wgrad": [_P] * 5 + [_I] * 11 + [_P],
    "repro_elastic_matmul_dgrad_tma": [_P] * 4 + [_I] * 7 + [_P],
    "repro_elastic_matmul_wgrad_tma": [_P] * 6 + [_I] * 11 + [_P],
}


def _launcher(name: str):
    fn = getattr(build.library("elastic_matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def choose_variant(M: int, k_act: int, n_act: int, dtype: torch.dtype,
                   ldx: int, ldw: int, aligned: bool) -> str:
    """The kernel a call goes to.  ``ldx``/``ldw`` are the row strides in
    elements, ``aligned`` whether x's and w's bases are 16-byte aligned
    (TMA and f32_splitk's 16-byte loads need both, and row strides that
    are multiples of 16 bytes)."""
    if M <= SMALL_M_MAX:
        return "small_m"
    if dtype != torch.bfloat16:
        if aligned and ldx % 4 == 0 and ldw % 4 == 0:
            return "f32_splitk"
        return "tile_f32"
    if aligned and ldx % 8 == 0 and ldw % 8 == 0 and k_act >= 1 \
            and n_act >= 1:
        return "tma"
    return "tile_bf16"


def tma_tile(M: int, n_act: int, sms: int = SMS) -> tuple:
    """(consumer warpgroups, tile width) of the tma variant.  128x256 when
    its live tiles fill at least 3/4 of the SMs' waves (a last wave that
    is mostly idle costs a whole tile's time: N = 2816 at M = 2048 takes
    1.33 waves of it); else 128x128 when it gives about one block per SM
    (7/8 of the SMs or more); else 64x128, which spreads small products
    (the ViT's N = 384 layers) over more SMs."""
    tiles = _cdiv(M, 128) * _cdiv(n_act, 256)
    if tiles >= sms * 7 // 8 and 4 * tiles >= 3 * sms * _cdiv(tiles, sms):
        return 2, 256
    if _cdiv(M, 128) * _cdiv(n_act, 128) >= sms * 7 // 8:
        return 2, 128
    return 1, 128


def small_m_plan(k_act: int, n_act: int, elem_bytes: int,
                 sms: int = SMS) -> tuple:
    """(splits, rows per split) of the small_m kernel's K: enough blocks
    for ~4 per SM over the ``cdiv(n_act, 64)`` column tiles, no split
    under 256 rows, none over the 512 rows of x a block stages; rows per
    split a multiple of the rows a block reads at once."""
    # 256 threads, 16 bytes each, 64 columns a row
    rows_at_once = 256 // (SMALL_M_BN // (16 // elem_bytes))
    if k_act <= 0 or n_act <= 0:
        return 1, rows_at_once
    n_tiles = _cdiv(n_act, SMALL_M_BN)
    splits = min(_cdiv(4 * sms, n_tiles), max(1, k_act // SMALL_M_KC_MIN))
    kc = _cdiv(_cdiv(k_act, splits), rows_at_once) * rows_at_once
    kc = min(kc, SMALL_M_KC_MAX)
    return _cdiv(k_act, kc), kc


def f32_splitk_plan(M: int, k_act: int, n_act: int, sms: int = SMS
                    ) -> tuple:
    """(splits, rows of K per split) of the f32_splitk kernel over its
    64 x 64 tiles (the router's prefill, M = 2048 x 64 experts: 32 tiles):
    as many splits of K as fill the SMs at two (tile, split) blocks each
    (the router: 8 splits, 256 blocks), no split under 128 rows of K and
    no more than 16 (the last block of a tile reads every split's partial
    back alone); rows per split a multiple of the 16 a stage holds, the
    splits covering k_act exactly once."""
    if k_act <= 0:
        return 1, F32_SPLITK_BK
    tiles = _cdiv(max(M, 1), F32_SPLITK_BM) \
        * max(1, _cdiv(n_act, F32_SPLITK_BN))
    splits = max(1, min(F32_SPLITK_BLOCKS_PER_SM * sms // tiles,
                        k_act // F32_SPLITK_KC_MIN, F32_SPLITK_SPLITS_MAX))
    kc = _cdiv(_cdiv(k_act, splits), F32_SPLITK_BK) * F32_SPLITK_BK
    return _cdiv(k_act, kc), kc


def _row_stride(t: torch.Tensor) -> int:
    # a size-1 leading dim may carry any stride; the kernel never steps it
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def check_args(x: torch.Tensor, w: torch.Tensor, k_act: int, n_act: int,
               n_out: int, plain: bool = False) -> None:
    """The kernel takes fp32 and bf16; its ``plain`` version float64 too
    (the CPU parity tests of the conv nets, held in float64)."""
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"x and w must be 2-D, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.dtype != w.dtype or not (x.dtype in DTYPE_CODES or plain
                                  and x.dtype == torch.float64):
        raise TypeError(f"x and w must share a dtype in float32/bfloat16"
                        f"{'/float64' if plain else ''}, got {x.dtype} and "
                        f"{w.dtype}")
    if not (0 <= k_act <= min(x.shape[1], w.shape[0])):
        raise ValueError(f"k_act={k_act} outside x {tuple(x.shape)} / "
                         f"w {tuple(w.shape)}")
    if not (0 <= n_act <= min(n_out, w.shape[1])):
        raise ValueError(f"n_act={n_act} outside n_out={n_out} / "
                         f"w {tuple(w.shape)}")


def elastic_matmul(x: torch.Tensor, w: torch.Tensor, widths: torch.Tensor,
                   k_act: int, n_act: int, n_out: int) -> torch.Tensor:
    """Launch the CUDA kernel: x (M, >=k_act), w (>=k_act, >=n_act) with unit
    inner strides, ``widths`` the device int32 tensor [k_act, n_act]."""
    check_args(x, w, k_act, n_act, n_out)
    dev = x.device
    if dev.type != "cuda" or w.device != dev or widths.device != dev:
        raise ValueError(f"elastic_matmul needs x, w and widths on one CUDA "
                         f"device, got {dev}, {w.device}, {widths.device}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {dev} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if widths.dtype != torch.int32 or widths.shape != (2,) \
            or not widths.is_contiguous():
        raise ValueError("widths must be a contiguous int32 tensor of 2")
    if (x.shape[1] > 1 and x.stride(1) != 1) or \
            (w.shape[1] > 1 and w.stride(1) != 1):
        raise ValueError("x and w need a unit inner stride (row-major rows)")
    M = x.shape[0]
    y = torch.empty((M, n_out), dtype=x.dtype, device=dev)
    if M == 0 or n_out == 0:
        return y
    ldx, ldw = _row_stride(x), _row_stride(w)
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    variant = choose_variant(M, k_act, n_act, x.dtype, ldx, ldw, aligned)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = DTYPE_CODES[x.dtype]
    if variant == "small_m":
        splits, kc = small_m_plan(k_act, n_act, x.element_size())
        ws = None if splits == 1 else torch.empty(
            (splits, M, n_act), dtype=torch.float32, device=dev)
        vec_ok = w.data_ptr() % 16 == 0 \
            and ldw % (16 // x.element_size()) == 0
        rc = _launcher("repro_elastic_matmul_small_m")(
            x.data_ptr(), w.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(), widths.data_ptr(), M, ldx,
            ldw, n_out, n_out, n_act, splits, kc, int(vec_ok), code, stream)
    elif variant == "f32_splitk":
        splits, kc = f32_splitk_plan(M, k_act, n_act)
        bm, bn = F32_SPLITK_BM, F32_SPLITK_BN
        tiles = _cdiv(M, bm) * _cdiv(n_act, bn)
        if splits > 1 and tiles > TILE_COUNTERS:
            raise ValueError(f"f32_splitk: {tiles} tiles, more than the "
                             f"{TILE_COUNTERS} counters")
        ws = None if splits == 1 else torch.empty(
            (splits, tiles, bm * bn), dtype=torch.float32, device=dev)
        rc = _launcher("repro_elastic_matmul_f32_splitk")(
            x.data_ptr(), w.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(),
            tile_counters(dev).data_ptr(), widths.data_ptr(), M, ldx, ldw,
            n_out, n_out, k_act, n_act, splits, kc, stream)
    elif variant == "tma":
        rc = _launcher("repro_elastic_matmul_tma")(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), widths.data_ptr(), M,
            ldx, ldw, n_out, n_out, k_act, n_act, *tma_tile(M, n_act),
            stream)
    else:
        rc = _launcher("repro_elastic_matmul")(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), widths.data_ptr(), M,
            ldx, ldw, n_out, n_out, code, stream)
    if rc != 0:
        raise RuntimeError(f"elastic_matmul ({variant}) launch failed "
                           f"(CUDA error {rc})")
    counting.count(_self, variant)
    return y


def elastic_matmul_plain(x: torch.Tensor, w: torch.Tensor, k_act: int,
                         n_act: int, n_out: int) -> torch.Tensor:
    """The same function in plain PyTorch (slice, matmul, zero-pad)."""
    check_args(x, w, k_act, n_act, n_out, plain=True)
    y = x[:, :k_act] @ w[:k_act, :n_act]
    if n_out > n_act:
        y = torch.nn.functional.pad(y, (0, n_out - n_act))
    return y


# ---------------------------------------------------------------- backward --

def wgrad_plan(M: int, k_act: int, n_act: int, sms: int = SMS) -> tuple:
    """(splits, rows per split) of the wmma_bf16 and fma_f32 wgrad
    kernels' M: about two blocks per SM over the ``cdiv(k_act, 128) *
    cdiv(n_act, 128)`` output tiles (the ViT's 384 x 384 weights give 9),
    no split under 256 rows; rows per split a multiple of the kernel's
    reduction step (32)."""
    if M <= 0:
        return 1, 32
    tiles = max(1, _cdiv(k_act, BWD_TILE) * _cdiv(n_act, BWD_TILE))
    splits = max(1, min(_cdiv(2 * sms, tiles), M // WGRAD_ROWS_MIN))
    chunk = _cdiv(_cdiv(M, splits), 32) * 32
    return _cdiv(M, chunk), chunk


def wgrad_tma_plan(M: int, k_act: int, n_act: int, sms: int = SMS
                   ) -> tuple:
    """(splits, rows per split) of the tma wgrad kernel's M: as many
    splits as fit one (tile, split) block an SM over the active block's
    tiles -- one wave: a block over it costs a second wave -- but no
    more than WGRAD_TMA_SPLITS_MAX (the last block of a tile reads every
    split's 64 KB partial back alone: past ~14 that tail costs more than
    the shorter chunks save) and no split under 256 rows.  Rows per split
    are whole 64-row TMA boxes (a box cannot be clipped to a split's end,
    so only the last split may meet M's edge), and the splits cover M
    exactly once.  The sweep in ``sweep_splits.py`` times split counts at
    the training step's shapes (PERF.md)."""
    if M <= 0:
        return 1, TMA_BOX
    tiles = max(1, _cdiv(k_act, BWD_TMA_TILE[0]) *
                _cdiv(n_act, BWD_TMA_TILE[1]))
    splits = max(1, min(sms // tiles, WGRAD_TMA_SPLITS_MAX,
                        M // WGRAD_ROWS_MIN))
    chunk = _cdiv(_cdiv(M, splits), TMA_BOX) * TMA_BOX
    return _cdiv(M, chunk), chunk


def choose_bwd_variant(M: int, k_act: int, n_act: int, dtype: torch.dtype,
                       lds: tuple, aligned: bool) -> str:
    """The kernel a dgrad or wgrad call over M rows goes to.  ``lds`` are
    the row strides in elements of the tensors TMA would read or write
    (dgrad: dy, w and dx; wgrad: x and dy), ``aligned`` whether their
    bases are 16-byte aligned: TMA needs that, row strides of whole 16
    bytes, and M and both widths >= 1 (a tensor map has no empty dim)."""
    if dtype != torch.bfloat16:
        return "fma_f32"
    if aligned and all(ld % 8 == 0 for ld in lds) and min(M, k_act,
                                                           n_act) >= 1:
        return "tma"
    return "wmma_bf16"


def _bwd_variant(a: torch.Tensor, b: torch.Tensor, k_act: int, n_act: int,
                 variant: Optional[str], out_ld: int = 8) -> str:
    """The variant of a backward call on operands a and b (and an output
    of row stride ``out_ld`` that TMA writes): the chosen one, or
    ``variant`` when the caller names one the call can take."""
    lds = (_row_stride(a), _row_stride(b), out_ld)
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    best = choose_bwd_variant(a.shape[0], k_act, n_act, a.dtype, lds,
                              aligned)
    if variant is None or variant == best:
        return best
    if variant == "wmma_bf16" and a.dtype == torch.bfloat16:
        return variant
    raise ValueError(f"backward variant {variant!r} cannot take this call "
                     f"(it takes {best!r})")


def _check_cuda(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"needs every tensor on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {dev} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if any(t.dtype != ts[0].dtype for t in ts) or \
            ts[0].dtype not in DTYPE_CODES:
        raise TypeError(f"tensors must share a dtype in float32/bfloat16, "
                        f"got {[t.dtype for t in ts]}")
    return dev


def _unit_inner(t: torch.Tensor) -> torch.Tensor:
    return t if t.shape[1] <= 1 or t.stride(1) == 1 else t.contiguous()


def _vec_ok(*ts: torch.Tensor) -> bool:
    """16-byte loads: bf16 rows with 16-byte-aligned bases and strides."""
    return all(t.dtype == torch.bfloat16 and t.data_ptr() % 16 == 0
               and _row_stride(t) % 8 == 0 for t in ts)


_counters: Dict[torch.device, torch.Tensor] = {}
_counters_lock = threading.Lock()


def tile_counters(device: torch.device) -> torch.Tensor:
    """The per-tile tickets of the tma wgrad and f32_splitk kernels on
    ``device``: int32 zeros, allocated once (each kernel leaves them at 0)
    and never replaced, so a CUDA graph that captured a call keeps a valid
    pointer.  Calls that use them must not overlap on two streams."""
    with _counters_lock:
        t = _counters.get(device)
        if t is None:
            t = torch.zeros(TILE_COUNTERS, dtype=torch.int32, device=device)
            _counters[device] = t
        return t


def elastic_matmul_dgrad(dy: torch.Tensor, w: torch.Tensor,
                         widths: torch.Tensor, k_act: int, n_act: int,
                         kx: int, *, variant: Optional[str] = None
                         ) -> torch.Tensor:
    """Launch the dgrad kernel: dy (M, >=n_act), w (>=k_act, >=n_act) ->
    dx (M, kx) with ``dx[:, :k_act] = dy[:, :n_act] @ w[:k_act, :n_act]^T``
    and exact zeros past k_act.  ``variant`` names the kernel (by default
    :func:`choose_bwd_variant`'s; bf16 may name ``wmma_bf16``)."""
    dev = _check_cuda(dy, w)
    if dy.ndim != 2 or w.ndim != 2 or not (
            0 <= n_act <= min(dy.shape[1], w.shape[1])
            and 0 <= k_act <= min(kx, w.shape[0])):
        raise ValueError(f"dgrad: dy {tuple(dy.shape)}, w {tuple(w.shape)}, "
                         f"k_act={k_act}, n_act={n_act}, kx={kx}")
    dy, w = _unit_inner(dy), _unit_inner(w)
    M = dy.shape[0]
    dx = torch.empty((M, kx), dtype=dy.dtype, device=dev)
    if M == 0 or kx == 0:
        return dx
    variant = _bwd_variant(dy, w, k_act, n_act, variant, kx)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if variant == "tma":
        rc = _launcher("repro_elastic_matmul_dgrad_tma")(
            dy.data_ptr(), w.data_ptr(), dx.data_ptr(), widths.data_ptr(), M,
            _row_stride(dy), _row_stride(w), kx, kx, w.shape[0], n_act,
            stream)
    else:
        rc = _launcher("repro_elastic_matmul_dgrad")(
            dy.data_ptr(), w.data_ptr(), dx.data_ptr(), widths.data_ptr(), M,
            _row_stride(dy), _row_stride(w), kx, kx, int(_vec_ok(dy, w)),
            DTYPE_CODES[dy.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"elastic_matmul dgrad ({variant}) launch failed "
                           f"(CUDA error {rc})")
    counting.count(_self, variant, "dgrad_launches",
                   "dgrad_variant_launches")
    return dx


def elastic_matmul_wgrad(x: torch.Tensor, dy: torch.Tensor,
                         widths: torch.Tensor, k_act: int, n_act: int,
                         w_shape: tuple, *, variant: Optional[str] = None
                         ) -> torch.Tensor:
    """Launch the wgrad kernel: x (M, >=k_act), dy (M, >=n_act) -> dw of
    ``w_shape`` with ``dw[:k_act, :n_act] = x[:, :k_act]^T @ dy[:, :n_act]``
    (fp32 accumulation, the splits of M added in order) and exact zeros
    elsewhere.  ``variant`` as for :func:`elastic_matmul_dgrad`."""
    dev = _check_cuda(x, dy)
    Kw, Nw = w_shape
    if x.ndim != 2 or dy.ndim != 2 or x.shape[0] != dy.shape[0] or not (
            0 <= k_act <= min(x.shape[1], Kw)
            and 0 <= n_act <= min(dy.shape[1], Nw)):
        raise ValueError(f"wgrad: x {tuple(x.shape)}, dy {tuple(dy.shape)}, "
                         f"w {tuple(w_shape)}, k_act={k_act}, n_act={n_act}")
    x, dy = _unit_inner(x), _unit_inner(dy)
    M = x.shape[0]
    dw = torch.empty((Kw, Nw), dtype=x.dtype, device=dev)
    if Kw * Nw == 0:
        return dw
    variant = _bwd_variant(x, dy, k_act, n_act, variant)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if variant == "tma":
        splits, chunk = wgrad_tma_plan(M, k_act, n_act)
        bm, bn = BWD_TMA_TILE
        tiles = _cdiv(k_act, bm) * _cdiv(n_act, bn)
        # the tickets sum a tile's splits; one split stores in place (the
        # 152064-wide head of qwen1.5-110b: 76032 tiles)
        if splits > 1 and tiles > TILE_COUNTERS:
            raise ValueError(f"wgrad: {tiles} tiles, more than the "
                             f"{TILE_COUNTERS} counters")
        ws = None if splits == 1 else torch.empty(
            (splits, tiles, bm * bn), dtype=torch.float32, device=dev)
        rc = _launcher("repro_elastic_matmul_wgrad_tma")(
            x.data_ptr(), dy.data_ptr(), None if ws is None else ws.data_ptr(),
            dw.data_ptr(), tile_counters(dev).data_ptr(), widths.data_ptr(),
            M, _row_stride(x), _row_stride(dy), Kw, Nw, k_act, n_act,
            x.shape[1], dy.shape[1], splits, chunk, stream)
    else:
        splits, chunk = wgrad_plan(M, k_act, n_act)
        ipad = max(1, _cdiv(k_act, BWD_TILE)) * BWD_TILE
        jpad = max(1, _cdiv(n_act, BWD_TILE)) * BWD_TILE
        ws = torch.empty((splits, ipad, jpad), dtype=torch.float32,
                         device=dev)
        rc = _launcher("repro_elastic_matmul_wgrad")(
            x.data_ptr(), dy.data_ptr(), ws.data_ptr(), dw.data_ptr(),
            widths.data_ptr(), M, _row_stride(x), _row_stride(dy), Kw, Nw,
            ipad, jpad, splits, chunk, int(_vec_ok(x, dy)),
            DTYPE_CODES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"elastic_matmul wgrad ({variant}) launch failed "
                           f"(CUDA error {rc})")
    counting.count(_self, variant, "wgrad_launches",
                   "wgrad_variant_launches")
    return dw


def elastic_matmul_dgrad_plain(dy: torch.Tensor, w: torch.Tensor,
                               k_act: int, n_act: int,
                               kx: int) -> torch.Tensor:
    """dgrad in plain PyTorch: one product on the active block, zero-pad."""
    dx = dy[:, :n_act] @ w[:k_act, :n_act].T
    return torch.nn.functional.pad(dx, (0, kx - k_act))


def elastic_matmul_wgrad_plain(x: torch.Tensor, dy: torch.Tensor,
                               k_act: int, n_act: int,
                               w_shape: tuple) -> torch.Tensor:
    """wgrad in plain PyTorch: one product on the active block, zero-pad."""
    dw = x[:, :k_act].T @ dy[:, :n_act]
    return torch.nn.functional.pad(dw, (0, w_shape[1] - n_act,
                                        0, w_shape[0] - k_act))
