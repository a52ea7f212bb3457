"""Row sort and row top-k: the hand-written Hopper kernels of
`csrc/select_ops.cu` and their wrappers.

They replace Mosaic probe kernels of scripts/probe_kernel_ops.py:
- `row_sort`: `build_sort` (:212), a stable ascending sort of each row, with
  its permutation on request; the list backend's merge, the byte-map's
  expansion sort, the "exact" selection and the wide hop's id sort;
- `row_topk`: `build_topk` (:222), `lax.top_k` of each row, ties to the
  lower index; every masked top-k of the search, the "topk" and "approx"
  selections, the wide hop's selection and the brute-force oracle.
The third, `build_take_along` (:186), `take_along_axis` within rows, is
`visited_ops.gather_elems` of a per-query table with the clip bound W - 1:
the id gathers behind the top-ks.

Keys are int32 or float32; -0.0 and +0.0 tie, as they compare equal.

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs the plain version beside it, which is also what the kernel is held
against on the card. Shapes, types and devices are checked on both. Each
wrapper's `.launches` counts its calls that launched: one device kernel a
call on rows of up to SHORT_ROW keys; above it, nine for `row_sort` (a
tiled sort's prepare, plan, upsweeps and downsweeps) and ten for `row_topk`
(a histogram and a plan kernel a digit, the filter, the finish; nineteen
when k > SHORT_ROW, whose winners go through the tiled sort and a gather).

`selects(plain)` gives the sort, the top-k and the element gather as one
object, the kernels (the default) or the plain versions, so that a caller
can switch all of them at once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from . import build, visited_ops

_KEY_TYPES = (torch.int32, torch.float32)


class SelectArgs(ctypes.Structure):
    """Mirrors `NannSelectArgs` in csrc/select_ops.cu, field for field."""

    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("perm", ctypes.c_void_p), ("scratch", ctypes.c_void_p),
                ("B", ctypes.c_int64),
                ("W", ctypes.c_int64), ("K", ctypes.c_int64),
                ("scratch_words", ctypes.c_int64),
                ("is_float", ctypes.c_int32), ("largest", ctypes.c_int32)]


# The row sort's and row top-k's paths, mirroring csrc/select_ops.cu: rows
# of up to SHORT_ROW keys in one block ("short", no scratch); wider rows in
# tiles of SORT_TILE keys, one block a tile ("tiled").
SORT_PATHS = ("short", "tiled")
SHORT_ROW = 8192          # kShortRow
SORT_TILE = 4096          # kSortTile
_BINS = 256               # kBins
_STATE_WORDS = 8          # kStateWords


def _sort_plan(B: int, W: int):
    """(path, tiles, scratch_words) of a row sort of [B, W], as the kernel
    library picks it from the width: the path, the tiles a row is cut into
    and the int32 words of scratch it needs (tiled_scratch_words in the
    .cu: keys and indices twice, the tiles' histograms of four digits and
    of one, the bucket bases and the flags)."""
    if W <= SHORT_ROW:
        return "short", 1, 0
    tiles = -(-W // SORT_TILE)
    words = (4 * B * tiles * SORT_TILE + B * tiles * 5 * _BINS
             + B * 4 * _BINS + B)
    return "tiled", tiles, words


def _topk_plan(B: int, W: int, k: int):
    """(path, tiles, scratch_words) of a row top-k of [B, W], as the kernel
    library picks it from the width: the path, the tiles a row is cut into
    and the int32 words of scratch it needs (topk_scratch_words in the .cu:
    one digit's tile counts, each tile's keys below the bucket and in it,
    the AND and OR of each tile's keys that share the prefix, the rows'
    state, the certain winners' keys and indices; then the
    candidates' keys and indices for k <= SHORT_ROW, else the sorted
    winners' keys and permutation and the tiled sort's scratch of [B, k])."""
    if W <= SHORT_ROW:
        return "short", 1, 0
    tiles = -(-W // SORT_TILE)
    words = B * tiles * _BINS + 4 * B * tiles + B * _STATE_WORDS + 2 * B * k
    if k <= SHORT_ROW:         # kCandidates: a finish block takes one short row
        words += 2 * B * SHORT_ROW
    else:
        words += 2 * B * k + _sort_plan(B, k)[2]
    return "tiled", tiles, words


# ------------------------------------------------------------ plain versions


def row_sort_plain(x: torch.Tensor, with_perm: bool = False):
    """Each row of x [B, W] sorted ascending, stable; with_perm also gives
    the int32 permutation: (values, perm)."""
    values, perm = torch.sort(x, dim=-1, stable=True)
    return (values, perm.int()) if with_perm else values


def row_topk_plain(x: torch.Tensor, k: int, largest: bool = True):
    """(values [B, k], int32 indices [B, k]) of the k largest (or smallest)
    of each row, in the order of a stable sort: ties to the lower index."""
    values, order = torch.sort(x, dim=-1, descending=largest, stable=True)
    return values[:, :k].contiguous(), order[:, :k].int().contiguous()


# ------------------------------------------------------------------ checks


def _check_rows(x: torch.Tensor) -> None:
    if x.dtype not in _KEY_TYPES:
        raise TypeError(f"x must be int32 or float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D [B, W], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.shape[1] >= 2**31:
        raise ValueError(f"rows of {x.shape[1]} do not fit int32 indices")


# ----------------------------------------------------------------- library


def check_struct(lib) -> None:
    """Raise unless the library's NannSelectArgs has the size of SelectArgs
    and its last field the same offset."""
    got = {}
    for fn in ("nann_select_args_size", "nann_select_args_largest_offset"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_size_t
        got[fn] = getattr(lib, fn)()
    want = {"nann_select_args_size": ctypes.sizeof(SelectArgs),
            "nann_select_args_largest_offset": SelectArgs.largest.offset}
    if got != want:
        raise RuntimeError(f"NannSelectArgs in the library ({got}) differs "
                           f"from SelectArgs ({want})")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library, built at first use; its argument types are set
    and its struct layout is checked once."""
    lib = build.load("select_ops")
    check_struct(lib)
    for fn in ("nann_row_sort", "nann_row_topk"):
        getattr(lib, fn).argtypes = [ctypes.POINTER(SelectArgs),
                                     ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int
    lib.nann_select_init.argtypes = []
    lib.nann_select_init.restype = ctypes.c_int
    lib.nann_row_sort_scratch_words.argtypes = [ctypes.c_int64,
                                                ctypes.c_int64]
    lib.nann_row_sort_scratch_words.restype = ctypes.c_int64
    lib.nann_row_topk_scratch_words.argtypes = [ctypes.c_int64] * 3
    lib.nann_row_topk_scratch_words.restype = ctypes.c_int64
    lib.nann_row_sort_blocks_per_sm.argtypes = [ctypes.c_int]
    lib.nann_row_sort_blocks_per_sm.restype = ctypes.c_int
    lib.nann_select_error_string.argtypes = [ctypes.c_int]
    lib.nann_select_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _init(index: int) -> None:
    """Opt the kernels in to their shared memory on one device, once."""
    lib = _library()
    with torch.cuda.device(index):
        err = lib.nann_select_init()
    if err != 0:
        raise RuntimeError("nann_select_init failed: "
                           + lib.nann_select_error_string(err).decode())


def _launch(fn_name: str, args: SelectArgs, device: torch.device) -> None:
    lib = _library()
    _init(device.index if device.index is not None
          else torch.cuda.current_device())
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn_name)(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: "
                           + lib.nann_select_error_string(err).decode())


def blocks_per_sm(path: str, device: torch.device) -> int:
    """Blocks of a row_sort path that fit one SM of `device` at once (the
    tiled path's: its downsweep's)."""
    _init(device.index if device.index is not None
          else torch.cuda.current_device())
    n = _library().nann_row_sort_blocks_per_sm(SORT_PATHS.index(path))
    if n < 0:
        raise RuntimeError("nann_row_sort_blocks_per_sm failed: "
                           + _library().nann_select_error_string(-n).decode())
    return n


# ---------------------------------------------------------------- wrappers


def row_sort(x: torch.Tensor, with_perm: bool = False):
    """Each row of an int32 or float32 x [B, W] sorted ascending, stable
    (equal keys keep the lower index first); with_perm also gives the int32
    permutation: (values, perm). One call is one launch in `.launches`, of
    one device kernel on the short path and nine on the tiled path
    (`_sort_plan`)."""
    _check_rows(x)
    if x.device.type == "cpu":
        return row_sort_plain(x, with_perm)
    B, W = x.shape
    words = _sort_plan(B, W)[2]
    out = torch.empty_like(x)
    perm = torch.empty((B, W), dtype=torch.int32, device=x.device) \
        if with_perm else None
    if x.numel():
        scratch = torch.empty(words, dtype=torch.int32, device=x.device) \
            if words else None
        _launch("nann_row_sort", SelectArgs(
            x=x.data_ptr(), out=out.data_ptr(),
            perm=perm.data_ptr() if with_perm else None,
            scratch=scratch.data_ptr() if words else None, B=B, W=W,
            scratch_words=words, is_float=int(x.dtype == torch.float32)),
            x.device)
        row_sort.launches += 1
    return (out, perm) if with_perm else out


def row_topk(x: torch.Tensor, k: int, largest: bool = True):
    """(values [B, k], int32 indices [B, k]) of the k largest (or smallest)
    of each row of an int32 or float32 x [B, W], in the order of a stable
    sort: ties to the lower index, as lax.top_k breaks them. One call is one
    launch in `.launches`, of one device kernel on the short path and ten
    (nineteen when k > SHORT_ROW) on the tiled path (`_topk_plan`)."""
    _check_rows(x)
    k = int(k)
    if not 0 <= k <= x.shape[1]:
        raise ValueError(f"k={k} outside [0, {x.shape[1]}]")
    if x.device.type == "cpu":
        return row_topk_plain(x, k, largest)
    B, W = x.shape
    words = _topk_plan(B, W, k)[2]
    values = torch.empty((B, k), dtype=x.dtype, device=x.device)
    indices = torch.empty((B, k), dtype=torch.int32, device=x.device)
    if values.numel():
        scratch = torch.empty(words, dtype=torch.int32, device=x.device) \
            if words else None
        _launch("nann_row_topk", SelectArgs(
            x=x.data_ptr(), out=values.data_ptr(), perm=indices.data_ptr(),
            scratch=scratch.data_ptr() if words else None, B=B, W=W, K=k,
            scratch_words=words, is_float=int(x.dtype == torch.float32),
            largest=int(largest)), x.device)
        row_topk.launches += 1
    return values, indices


row_sort.launches = 0
row_topk.launches = 0


class Selects(NamedTuple):
    """The row sort, the row top-k and the element gather (`take_along` is
    gather_elems(table, idx, W - 1)), all kernels or all plain versions."""

    row_sort: Callable
    row_topk: Callable
    gather_elems: Callable


def selects(plain: bool = False) -> Selects:
    """The kernels' wrappers, or with plain=True their plain versions."""
    if plain:
        return Selects(row_sort_plain, row_topk_plain,
                       visited_ops.gather_elems_plain)
    return Selects(row_sort, row_topk, visited_ops.gather_elems)
