"""Gathers and scatters of the visited backends: the hand-written Hopper
kernels of `csrc/visited_ops.cu` and their wrappers.

They replace the Mosaic probe kernels of scripts/probe_kernel_ops.py:
- `gather_elems`: `build_gather_flat` (:173), `build_gather_2d` (:247) and
  `build_take_along` (:186), which is a per-query table with hi = W - 1;
  the byte-map's `vis_unvisited`, both backends' `take_ids`, and the lane
  gathers behind the search's top-ks;
- `gather_rows`: `build_gather_rows` (:233); `take_rows` of the neighbour
  table;
- `scatter_set`: `build_scatter` (:198); `vis_mark` and `vis_reset_mark`.

A table is either one row shared by the batch (1-D, any shape of ids) or one
row per query (2-D [B, L], ids [B, M]). `scatter_set` writes in place, where
JAX returns a new table: the search owns its visited map, so no copy is kept.

`_visited_plan` gives the launch of `gather_elems` and `scatter_set` from
the types and shapes, as the library picks it (`library_plan` asks the
library): the "global" path (a 2-D grid of at most one or two resident
waves) for every shape, or, for a gather of int32 rows that fit shared
memory and are small against their ids (the wide hop's neighbour gather),
the "staged" path (one block a query row, the row and its ids staged in
shared memory). The staged kernel's shared memory is opted in once per
device, which also reads the device's SM count (`_init`).

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs the plain version beside it, which is also what the kernel is held
against on the card. Shapes, types and bounds are checked on both. Each
wrapper's `.launches` counts its kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import build

_ELEM_SIZE = {torch.uint8: 1, torch.int32: 4}


class VisitedArgs(ctypes.Structure):
    """Mirrors `NannVisitedArgs` in csrc/visited_ops.cu, field for field."""

    _fields_ = [("table", ctypes.c_void_p), ("ids", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("B", ctypes.c_int64),
                ("M", ctypes.c_int64), ("row_stride", ctypes.c_int64),
                ("n_cols", ctypes.c_int64), ("hi", ctypes.c_int64),
                ("width", ctypes.c_int64), ("value", ctypes.c_uint32),
                ("elem_size", ctypes.c_int32)]


# The element kernels' launch plan, mirroring csrc/visited_ops.cu (`plan`).
PATHS = ("global", "staged")
THREADS = 256              # kThreads: a block of the global path
WAVE_BLOCKS_PER_SM = 8     # kWaveBlocksPerSm: 2,048 threads an SM
GATHER_WAVES = 1           # kGatherWaves: a gather's global grid, in waves
SCATTER_WAVES = 2          # kScatterWaves: a scatter's
STAGE_THREADS = 1024       # kStageThreads: a block of the staged path
STAGE_COST = 12            # kStageCost: staged where (span + M) x this
                           # <= B x M
STAGE_MIN_IDS = 1 << 18    # kStageMinIds: staged launches have B x M at least
BLOCK_SMEM = 232_448       # kBlockSmem: dynamic shared memory a block
BARRIER_BYTES = 16         # kBarrierBytes
MAX_GRID_Y = 65_535        # kMaxGridY
H100_SMS = 132


class VisitedPlan(NamedTuple):
    """path ("global" or "staged"), grid (x, y), threads a block and bytes
    of dynamic shared memory a block."""
    path: str
    grid: Tuple[int, int]
    threads: int
    smem_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _staged_bytes(nbytes: int) -> int:
    """A staged copy in shared memory: at its global address's offset within
    16 bytes, so that the bulk copy's both ends are aligned."""
    return _cdiv(nbytes, 16) * 16 + 16


def _visited_plan(scatter: bool, elem_size: int, B: int, M: int,
                  per_query: bool, span: int, sms: int = H100_SMS
                  ) -> VisitedPlan:
    """The launch of `gather_elems` (scatter=False) or `scatter_set` over
    ids [B, M] and table elements of `elem_size` bytes, one row per query or
    one shared row, on a device of `sms` SMs. `span` is the elements of a
    row the kernel touches: hi + 1 for a gather, the row for a scatter.

    Staged, one block a query row: a gather of int32 rows, one per query,
    of at most one row an SM and at least STAGE_MIN_IDS ids in all, whose
    span and ids fit a block's shared memory beside the barrier, and where
    (span + M) x STAGE_COST <= B x M (the search's wide hop gathers its
    neighbours so: [64, 25,600] x [64, 8,192]). Else the global path: a
    grid of at most GATHER_WAVES (SCATTER_WAVES) resident waves, and no more
    blocks a row than its ids fill at one a thread."""
    if not scatter and elem_size == 4 and per_query and B <= sms \
            and B * M >= STAGE_MIN_IDS and (span + M) * STAGE_COST <= B * M:
        smem = BARRIER_BYTES + _staged_bytes(span * 4) + _staged_bytes(M * 4)
        if smem <= BLOCK_SMEM:
            return VisitedPlan("staged", (1, B), STAGE_THREADS, smem)
    gy = min(B, MAX_GRID_Y)
    grid_waves = SCATTER_WAVES if scatter else GATHER_WAVES
    gx = min(_cdiv(sms * WAVE_BLOCKS_PER_SM * grid_waves, gy),
             _cdiv(M, THREADS))
    return VisitedPlan("global", (max(gx, 1), gy), THREADS, 0)


def visited_plan(op: str, table: torch.Tensor, ids: torch.Tensor, arg: int,
                 sms: int = H100_SMS) -> VisitedPlan:
    """`_visited_plan` of `gather_elems(table, ids, hi=arg)` (op "gather")
    or `scatter_set(table, ids, value=arg)` (op "scatter")."""
    stride, B, M = _stride_and_rows(table, ids)
    scatter = op == "scatter"
    span = table.shape[-1] if scatter else arg + 1
    return _visited_plan(scatter, _ELEM_SIZE[table.dtype], B, M, stride != 0,
                         span, sms)


# ------------------------------------------------------------ plain versions


def gather_elems_plain(table: torch.Tensor, ids: torch.Tensor, hi: int
                       ) -> torch.Tensor:
    """table[clip(ids, 0, hi)] from a shared 1-D table, or
    table[b, clip(ids[b, j], 0, hi)] from a per-query [B, L] table."""
    idx = ids.long().clamp(0, hi)
    return table[idx] if table.dim() == 1 else table.gather(1, idx)


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows table[clip(ids, 0, N - 1)] of an [N, W] table: [*ids.shape, W]."""
    return table[ids.long().clamp(0, table.shape[0] - 1)]


def scatter_set_plain(table: torch.Tensor, ids: torch.Tensor, value: int
                      ) -> torch.Tensor:
    """table[b?, ids[b, j]] = value in place; ids outside the row are
    dropped. Returns table."""
    idx = ids.long()
    ok = (idx >= 0) & (idx < table.shape[-1])
    if table.dim() == 1:
        table[idx[ok]] = value
    else:
        rows = torch.arange(table.shape[0], device=table.device)[:, None]
        table[rows.expand_as(idx)[ok], idx[ok]] = value
    return table


# ------------------------------------------------------------------ checks


def _check_table(table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.dtype not in _ELEM_SIZE:
        raise TypeError(f"table must be uint8 or int32, got {table.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if table.dim() == 2:
        if ids.dim() != 2 or ids.shape[0] != table.shape[0]:
            raise ValueError(f"a per-query table {tuple(table.shape)} needs "
                             f"ids [{table.shape[0]}, M], got "
                             f"{tuple(ids.shape)}")
    elif table.dim() != 1:
        raise ValueError(f"table must be 1-D (shared) or 2-D (per query), "
                         f"got {tuple(table.shape)}")
    _check_common(table, ids)


def _check_common(table: torch.Tensor, ids: torch.Tensor) -> None:
    if ids.device != table.device:
        raise ValueError("ids must be on the table's device")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("table and ids must be contiguous")


def _stride_and_rows(table: torch.Tensor, ids: torch.Tensor):
    """(row_stride, B, M) of the kernel's [B, M] view of ids."""
    if table.dim() == 1:
        return 0, 1, ids.numel()
    return table.shape[1], ids.shape[0], ids.shape[1]


# ----------------------------------------------------------------- library


def check_struct(lib) -> None:
    """Raise unless the library's NannVisitedArgs has the size of
    VisitedArgs and its last field the same offset (a field on one side only
    would make the kernels read every later field from the wrong place)."""
    got = {}
    for fn in ("nann_visited_args_size", "nann_visited_args_elem_size_offset"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_size_t
        got[fn] = getattr(lib, fn)()
    want = {"nann_visited_args_size": ctypes.sizeof(VisitedArgs),
            "nann_visited_args_elem_size_offset": VisitedArgs.elem_size.offset}
    if got != want:
        raise RuntimeError(f"NannVisitedArgs in the library ({got}) differs "
                           f"from VisitedArgs ({want})")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library, built at first use; its argument types are set
    and its struct layout is checked once."""
    lib = build.load("visited_ops")
    check_struct(lib)
    for fn in ("nann_gather_elems", "nann_gather_rows", "nann_scatter_set"):
        getattr(lib, fn).argtypes = [ctypes.POINTER(VisitedArgs),
                                     ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int
    lib.nann_visited_error_string.argtypes = [ctypes.c_int]
    lib.nann_visited_error_string.restype = ctypes.c_char_p
    lib.nann_visited_init.argtypes = []
    lib.nann_visited_init.restype = ctypes.c_int
    lib.nann_visited_sms.argtypes = []
    lib.nann_visited_sms.restype = ctypes.c_int
    lib.nann_visited_plan.argtypes = [
        ctypes.POINTER(VisitedArgs), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int64)]
    lib.nann_visited_plan.restype = None
    lib.nann_visited_blocks_per_sm.argtypes = [ctypes.POINTER(VisitedArgs),
                                               ctypes.c_int]
    lib.nann_visited_blocks_per_sm.restype = ctypes.c_int
    return lib


def _error(lib, err: int) -> str:
    return lib.nann_visited_error_string(err).decode()


@functools.lru_cache(maxsize=None)
def _init(index: int) -> None:
    """Opt the staged kernels in to their shared memory and record the SM
    count on one device, once."""
    lib = _library()
    with torch.cuda.device(index):
        err = lib.nann_visited_init()
    if err != 0:
        raise RuntimeError("nann_visited_init failed: " + _error(lib, err))


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _launch(fn_name: str, args: VisitedArgs, device: torch.device) -> None:
    lib = _library()
    _init(_device_index(device))
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn_name)(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: " + _error(lib, err))


def _element_args(op: str, table: torch.Tensor, ids: torch.Tensor, arg: int,
                  out: torch.Tensor = None) -> VisitedArgs:
    """The arguments of gather_elems (op "gather", arg = hi) or scatter_set
    (op "scatter", arg = value)."""
    stride, B, M = _stride_and_rows(table, ids)
    common = dict(table=table.data_ptr(), ids=ids.data_ptr(), B=B, M=M,
                  row_stride=stride, elem_size=_ELEM_SIZE[table.dtype])
    if op == "scatter":
        return VisitedArgs(n_cols=table.shape[-1],
                           value=int(arg) & 0xFFFFFFFF, **common)
    return VisitedArgs(out=0 if out is None else out.data_ptr(), hi=arg,
                       **common)


def library_plan(op: str, table: torch.Tensor, ids: torch.Tensor, arg: int
                 ) -> Tuple[VisitedPlan, int]:
    """The kernel library's own plan of these CUDA inputs on their device
    (`nann_visited_plan` at the SM count `nann_visited_init` read), and the
    blocks of its kernel an SM holds (the occupancy calculator)."""
    lib = _library()
    _init(_device_index(table.device))
    args = _element_args(op, table, ids, arg)
    scatter = int(op == "scatter")
    path, threads = ctypes.c_int(), ctypes.c_int()
    gx, gy, smem = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    with torch.cuda.device(table.device):
        lib.nann_visited_plan(ctypes.byref(args), scatter,
                              lib.nann_visited_sms(), ctypes.byref(path),
                              ctypes.byref(gx), ctypes.byref(gy),
                              ctypes.byref(threads), ctypes.byref(smem))
        blocks = lib.nann_visited_blocks_per_sm(ctypes.byref(args), scatter)
    if blocks < 0:
        raise RuntimeError("nann_visited_blocks_per_sm failed: "
                           + _error(lib, -blocks))
    return VisitedPlan(PATHS[path.value], (gx.value, gy.value),
                       threads.value, smem.value), blocks


# ---------------------------------------------------------------- wrappers


def gather_elems(table: torch.Tensor, ids: torch.Tensor, hi: int
                 ) -> torch.Tensor:
    """Elements table[b?, clip(ids, 0, hi)], of ids' shape and the table's
    type (uint8 or int32). hi must lie inside the table's row."""
    _check_table(table, ids)
    if ids.numel() and not 0 <= hi < table.shape[-1]:
        raise ValueError(f"clip bound {hi} outside the table's row of "
                         f"{table.shape[-1]}")
    if table.device.type == "cpu":
        return gather_elems_plain(table, ids, hi)
    out = torch.empty(ids.shape, dtype=table.dtype, device=table.device)
    if ids.numel() == 0:
        return out
    _launch("nann_gather_elems", _element_args("gather", table, ids, hi, out),
            table.device)
    gather_elems.launches += 1
    return out


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows table[clip(ids, 0, N - 1)] of an int32 [N, W] table, as
    [*ids.shape, W]."""
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[0] == 0:
        raise TypeError(f"table must be a non-empty int32 [N, W], got "
                        f"{table.dtype} {tuple(table.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    _check_common(table, ids)
    if table.device.type == "cpu":
        return gather_rows_plain(table, ids)
    out = torch.empty((*ids.shape, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if out.numel() == 0:
        return out
    _launch("nann_gather_rows", VisitedArgs(
        table=table.data_ptr(), ids=ids.data_ptr(), out=out.data_ptr(), B=1,
        M=ids.numel(), hi=table.shape[0] - 1, width=table.shape[1],
        elem_size=4), table.device)
    gather_rows.launches += 1
    return out


def scatter_set(table: torch.Tensor, ids: torch.Tensor, value: int
                ) -> torch.Tensor:
    """table[b?, ids] = value, in place; ids outside the row are dropped.
    Returns table."""
    _check_table(table, ids)
    lo, hi = (0, 255) if table.dtype == torch.uint8 else (-2**31, 2**31 - 1)
    if not lo <= int(value) <= hi:
        raise ValueError(f"value {value} does not fit {table.dtype}")
    if table.device.type == "cpu":
        return scatter_set_plain(table, ids, value)
    if ids.numel() == 0:
        return table
    _launch("nann_scatter_set", _element_args("scatter", table, ids, value),
            table.device)
    scatter_set.launches += 1
    return table


gather_elems.launches = 0
gather_rows.launches = 0
scatter_set.launches = 0
