"""Frontier scorer: the hand-written Hopper kernel and its wrapper.

`score_frontier` gathers each frontier row from the item table and runs the
folded scorer chain on it in one launch of `csrc/frontier_scorer.cu`. It
replaces the Pallas kernels of nann_tpu/experimental/pallas_scorer.py:
`_score_kernel` for a table of float32 or bfloat16 rows, and
`_score_kernel_int8` for a packed int8 table (`index/quantize.py`: int8
[N, D+4], each row's float32 scale in its last 4 bytes), whose rows the
kernel dequantizes to the compute type as it gathers them. The compute type
is that of `k_proj`, as in JAX, where packed rows are dequantized to the
model's compute dtype (nann_tpu/search/beam.py:459-463).

On a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
`frontier_scorer_plain`, the same function in plain PyTorch, which is also
what the kernel is held against on the card. `_scorer_plan` gives a launch's
rows a block, threads, shared memory and blocks an SM, as the kernel library
picks them from the compute type and the widths (bfloat16 on the tensor
cores, 128 rows a block at the serving width; float32 on the CUDA cores, 32).

`score_frontier.launches` counts launches on float tables,
`score_frontier.launches_int8` launches on packed int8 tables.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import torch

from ..index.quantize import unpack_rows
from ..ops.scorer_kernel import score_frontier_reference
from . import build

MATRICES = ("q1_k", "q2_k", "h1_k", "h2_k", "h3_k", "h4_k")
VECTORS = ("q1_b", "q1_alpha", "q2_b",
           "h1_scale", "h1_shift", "h1_alpha",
           "h2_scale", "h2_shift", "h2_alpha",
           "h3_scale", "h3_shift", "h3_alpha",
           "h4_scale", "h4_shift")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SEQ = 64

# The launch plan, mirroring csrc/frontier_scorer.cu (plan_bf16, plan_f32,
# launch_plan): a float32 block scores ROWS_F32 rows with THREADS threads; a
# bfloat16 block 16 rows a warp, at most ROWS_BF16, staging weights CHUNK
# columns at a time, rows padded by PAD elements.
THREADS = 256             # kThreads
ROWS_F32 = 32             # kRowsF32
ROWS_BF16 = 128           # kRowsBf16
CHUNK = 32                # kChunk
PAD = 8                   # kPad
BLOCK_SMEM = 232_448      # kBlockSmem: dynamic shared memory a block
SM_SMEM = 233_472         # kSmSmem: shared memory an SM
RESERVED = 1024           # kReserved: the runtime's own, a block
MAX_REGS = 128            # registers a thread under __launch_bounds__(256, 2)


class ScorerPlan(NamedTuple):
    """rows a block (0: no plan fits the widths), threads a block, bytes of
    dynamic shared memory a block, and the blocks an SM holds at least."""
    rows: int
    threads: int
    smem_bytes: int
    blocks_per_sm: int


def _ru16(n: int) -> int:
    return (n + 15) // 16 * 16


def _bf16_bytes(rows, D, DU, H1, DK, G1, G2, G3, L) -> int:
    """plan_bf16's bytes: the rows' offsets and scales, X [rows][xw],
    P [rows][pw], the values [lp][vw] and two chunk buffers (weights
    [kmax][CHUNK + PAD] and keys [lp][CHUNK + PAD]), in bf16."""
    dp, dup = _ru16(D), _ru16(DU)
    xk = dp + dup
    xw = max(xk, _ru16(G2)) + PAD
    pw = max(_ru16(H1), _ru16(G1), _ru16(G3)) + PAD
    kmax = max(dp, _ru16(H1), xk, _ru16(G1), _ru16(G2))
    lp = _ru16(L)
    return rows * 12 + 2 * (rows * xw + rows * pw + lp * (dup + PAD)
                            + 2 * (kmax + lp) * (CHUNK + PAD))


def _f32_bytes(D, DU, H1, DK, G1, G2, G3, L) -> int:
    """plan_f32's bytes: the rows' offsets and scales, X [32][DU + D],
    Q [32][max(DK, G2)] and U (q1; then the keys and softmax weights; then
    h1 and h3), in float32."""
    u = max(ROWS_F32 * H1, ROWS_F32 * max(G1, G3), L * (DK + 1) + ROWS_F32 * L)
    return ROWS_F32 * 12 + 4 * (ROWS_F32 * (DU + D)
                                + ROWS_F32 * max(DK, G2) + u)


def _scorer_plan(dtype: torch.dtype, packed: bool, D: int, DU: int, H1: int,
                 DK: int, G1: int, G2: int, G3: int, L: int) -> ScorerPlan:
    """The launch plan of a compute type, a storage (rows of the compute
    type or packed int8: the same plan) and the widths: float32 takes 32
    rows; bfloat16 the most rows of 128, 64, 32, 16 that leave two blocks an
    SM, else the most that fit one block's shared memory. Blocks an SM: as
    many as the shared memory, the threads and the registers (at most 128 a
    thread) hold. Depends on neither B nor F."""
    del packed
    if dtype == torch.bfloat16:
        two = SM_SMEM // 2 - RESERVED
        fits = [r for limit in (two, BLOCK_SMEM)
                for r in (ROWS_BF16, 64, 32, 16)
                if _bf16_bytes(r, D, DU, H1, DK, G1, G2, G3, L) <= limit]
        rows = fits[0] if fits else 0
        smem = _bf16_bytes(rows or 16, D, DU, H1, DK, G1, G2, G3, L)
        threads = 2 * rows
    else:
        smem = _f32_bytes(D, DU, H1, DK, G1, G2, G3, L)
        rows = ROWS_F32 if smem <= BLOCK_SMEM else 0
        threads = THREADS
    if rows == 0:
        return ScorerPlan(0, 0, smem, 0)
    blocks = min(SM_SMEM // (smem + RESERVED), 2048 // threads,
                 65536 // (threads * MAX_REGS))
    return ScorerPlan(rows, threads, smem, blocks)


def scorer_plan(weights: Dict[str, torch.Tensor], k_proj: torch.Tensor,
                v: torch.Tensor, table: torch.Tensor) -> ScorerPlan:
    """`_scorer_plan` of these inputs."""
    H1, G1, G2, G3 = (weights[k].shape[-1] for k in ("q1_k", "h1_k", "h2_k",
                                                     "h3_k"))
    return _scorer_plan(k_proj.dtype, table.dtype == torch.int8,
                        weights["q1_k"].shape[0], v.shape[2], H1,
                        k_proj.shape[2], G1, G2, G3, k_proj.shape[1])


class FrontierScorerArgs(ctypes.Structure):
    """Mirrors `NannScorerArgs` in csrc/frontier_scorer.cu, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "ids", "valid", "table", "k_proj", "v",
        "q1_k", "q1_b", "q1_a", "q2_k", "q2_b",
        "h1_k", "h1_s", "h1_t", "h1_a",
        "h2_k", "h2_s", "h2_t", "h2_a",
        "h3_k", "h3_s", "h3_t", "h3_a",
        "h4_k", "h4_s", "h4_t", "out")] + [("n_rows", ctypes.c_int64)] + [
        (name, ctypes.c_int) for name in (
            "B", "F", "L", "D", "H1", "DK", "DU", "G1", "G2", "G3", "dtype",
            "storage")]


def kernel_weights(folded: Dict[str, torch.Tensor], dt: torch.dtype
                   ) -> Dict[str, torch.Tensor]:
    """Folded weights as the kernel takes them: matrices in the compute dtype,
    vectors in float32, all contiguous. The plain version takes the same."""
    w = {k: folded[k].to(dt).contiguous() for k in MATRICES}
    w.update({k: folded[k].float().contiguous() for k in VECTORS})
    return w


def frontier_scorer_plain(weights: Dict[str, torch.Tensor],
                          k_proj: torch.Tensor, v: torch.Tensor,
                          table: torch.Tensor, ids: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather (ids clipped to the table), dequantize
    packed int8 rows to the compute type, score, and -inf for invalid rows
    (nann_tpu/search/beam.py:459-495)."""
    rows = table[ids.long().clamp(0, table.shape[0] - 1)]
    if table.dtype == torch.int8:
        rows = unpack_rows(rows, weights["q1_k"].shape[0], k_proj.dtype)
    scores = score_frontier_reference(weights, k_proj, v, rows, k_proj.dtype)
    return torch.where(valid, scores, torch.full_like(scores, float("-inf")))


def _width_ok(n: int) -> bool:
    return n % 256 == 0 or (n >= 8 and 256 % n == 0)


def _check(weights, k_proj, v, table, ids, valid):
    dt = k_proj.dtype
    if dt not in _DTYPES:
        raise TypeError(f"compute type (k_proj) must be float32 or bfloat16, "
                        f"got {dt}")
    if v.dtype != dt:
        raise TypeError(f"v must be {dt} like k_proj, got {v.dtype}")
    D = weights["q1_k"].shape[0]
    if table.dtype == torch.int8:
        if D % 4:
            raise ValueError(f"packed int8 rows need D % 4 == 0 (aligned "
                             f"scale and char4 loads), got D = {D}")
        if table.dim() != 2 or table.shape[1] != D + 4:
            raise ValueError(f"packed int8 table must be [N, D+4] = "
                             f"[N, {D + 4}], got {tuple(table.shape)}")
        if table.data_ptr() % 4:
            raise ValueError("packed int8 table must start 4-byte aligned")
    elif table.dtype != dt:
        raise TypeError(f"item table must be {dt} like k_proj, or packed "
                        f"int8, got {table.dtype}")
    elif table.dim() != 2 or table.shape[1] != D:
        raise ValueError(f"item table must be [N, D] = [N, {D}], got "
                         f"{tuple(table.shape)}")
    if ids.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError("ids must be int32 and valid bool")
    if ids.dim() != 2 or valid.shape != ids.shape:
        raise ValueError(f"ids {tuple(ids.shape)} and valid "
                         f"{tuple(valid.shape)} must be the same [B, F]")
    B = ids.shape[0]
    if k_proj.dim() != 3 or v.dim() != 3 or k_proj.shape[0] != B or \
            v.shape[:2] != k_proj.shape[:2]:
        raise ValueError(f"k_proj {tuple(k_proj.shape)} / v {tuple(v.shape)} "
                         f"must be [B={B}, L, *]")
    if not 1 <= k_proj.shape[1] <= MAX_SEQ:
        raise ValueError(f"sequence length must be in 1..{MAX_SEQ}")
    DK, DU = k_proj.shape[2], v.shape[2]
    H1, G1, G2, G3 = (weights[k].shape[-1] for k in ("q1_k", "h1_k", "h2_k",
                                                     "h3_k"))
    shapes = {"q1_k": (D, H1), "q2_k": (H1, DK), "h1_k": (DU + D, G1),
              "h2_k": (G1, G2), "h3_k": (G2, G3), "h4_k": (G3, 1),
              "q1_b": (H1,), "q1_alpha": (H1,), "q2_b": (DK,),
              "h4_scale": (1,), "h4_shift": (1,)}
    for i, g in ((1, G1), (2, G2), (3, G3)):
        shapes.update({f"h{i}_{k}": (g,) for k in ("scale", "shift", "alpha")})
    for k, shape in shapes.items():
        if tuple(weights[k].shape) != shape:
            raise ValueError(f"{k} has shape {tuple(weights[k].shape)}, "
                             f"the kernel needs {shape}")
    for k in MATRICES:
        if weights[k].dtype != dt:
            raise TypeError(f"{k} must be {dt} like k_proj")
    for n in (H1, DK, G1, G2, G3):
        if not _width_ok(n):
            raise ValueError(f"layer width {n} must divide 256 (>= 8) or be "
                             f"a multiple of 256")
    for k in (D, DU, H1, G1, G2):
        if k % 4:
            raise ValueError(f"inner width {k} must be a multiple of 4")
    for k in VECTORS:
        if weights[k].dtype != torch.float32:
            raise TypeError(f"{k} must be float32")
    tensors = [k_proj, v, table, ids, valid, *weights.values()]
    if any(t.device != table.device for t in tensors):
        raise ValueError("all inputs must be on the item table's device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    # 16-byte copies of the weights, 8-byte loads of rows and values
    if any(t.data_ptr() % 16 for t in (k_proj, v, *(weights[k]
                                                    for k in MATRICES))):
        raise ValueError("k_proj, v and the weight matrices must start "
                         "16-byte aligned")
    if table.dtype != torch.int8 and table.data_ptr() % 16:
        raise ValueError("the item table must start 16-byte aligned")
    if scorer_plan(weights, k_proj, v, table).rows == 0:
        raise ValueError("these widths need more shared memory than a block "
                         "has (see _scorer_plan)")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_struct(lib) -> None:
    """Raise unless the library's NannScorerArgs has the size of
    FrontierScorerArgs and its last field the same offset: a field added on
    one side only would make the kernel read every later field from the
    wrong offset, silently. The size alone misses an int added or dropped
    where the struct's tail padding absorbs it; the last field's offset
    does not."""
    got = {}
    for fn in ("nann_scorer_args_size", "nann_scorer_args_storage_offset"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_size_t
        got[fn] = getattr(lib, fn)()
    want = {"nann_scorer_args_size": ctypes.sizeof(FrontierScorerArgs),
            "nann_scorer_args_storage_offset": FrontierScorerArgs.storage.offset}
    if got != want:
        raise RuntimeError(f"NannScorerArgs in the library ({got}) differs "
                           f"from FrontierScorerArgs ({want})")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library, built at first use; its argument types are set
    and its struct size is checked once."""
    lib = build.load("frontier_scorer")
    check_struct(lib)
    lib.nann_frontier_scorer.argtypes = [ctypes.POINTER(FrontierScorerArgs),
                                         ctypes.c_void_p]
    lib.nann_frontier_scorer.restype = ctypes.c_int
    lib.nann_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nann_cuda_error_string.restype = ctypes.c_char_p
    lib.nann_scorer_init.argtypes = []
    lib.nann_scorer_init.restype = ctypes.c_int
    lib.nann_scorer_plan.argtypes = [ctypes.POINTER(FrontierScorerArgs)] + [
        ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.POINTER(ctypes.c_int64)]
    lib.nann_scorer_plan.restype = None
    lib.nann_scorer_blocks_per_sm.argtypes = [
        ctypes.POINTER(FrontierScorerArgs)]
    lib.nann_scorer_blocks_per_sm.restype = ctypes.c_int
    return lib


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None \
        else torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def _init(index: int) -> None:
    """Opt the kernels in to their shared memory on one device, once."""
    lib = _library()
    with torch.cuda.device(index):
        err = lib.nann_scorer_init()
    if err != 0:
        raise RuntimeError("nann_scorer_init failed: "
                           + lib.nann_cuda_error_string(err).decode())


def _args(weights, k_proj, v, table, ids, valid, out) -> FrontierScorerArgs:
    w = weights
    return FrontierScorerArgs(
        _ptr(ids), _ptr(valid), _ptr(table), _ptr(k_proj), _ptr(v),
        _ptr(w["q1_k"]), _ptr(w["q1_b"]), _ptr(w["q1_alpha"]),
        _ptr(w["q2_k"]), _ptr(w["q2_b"]),
        _ptr(w["h1_k"]), _ptr(w["h1_scale"]), _ptr(w["h1_shift"]),
        _ptr(w["h1_alpha"]),
        _ptr(w["h2_k"]), _ptr(w["h2_scale"]), _ptr(w["h2_shift"]),
        _ptr(w["h2_alpha"]),
        _ptr(w["h3_k"]), _ptr(w["h3_scale"]), _ptr(w["h3_shift"]),
        _ptr(w["h3_alpha"]),
        _ptr(w["h4_k"]), _ptr(w["h4_scale"]), _ptr(w["h4_shift"]), _ptr(out),
        table.shape[0], ids.shape[0], ids.shape[1], k_proj.shape[1],
        w["q1_k"].shape[0], w["q1_k"].shape[1], k_proj.shape[2], v.shape[2],
        w["h1_k"].shape[1], w["h2_k"].shape[1], w["h3_k"].shape[1],
        _DTYPES[k_proj.dtype], int(table.dtype == torch.int8))


def library_plan(weights, k_proj, v, table, ids, valid) -> ScorerPlan:
    """The kernel library's own plan for these CUDA inputs: rows, threads
    and shared memory from `nann_scorer_plan`, blocks an SM from the
    device's occupancy calculator."""
    lib = _library()
    _init(_device_index(table))
    args = _args(weights, k_proj, v, table, ids, valid,
                 torch.empty(0, device=table.device))
    rows, threads, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int64()
    lib.nann_scorer_plan(ctypes.byref(args), ctypes.byref(rows),
                         ctypes.byref(threads), ctypes.byref(smem))
    with torch.cuda.device(table.device):
        blocks = lib.nann_scorer_blocks_per_sm(ctypes.byref(args))
    if blocks < 0:
        raise RuntimeError("nann_scorer_blocks_per_sm failed: "
                           + lib.nann_cuda_error_string(-blocks).decode())
    return ScorerPlan(rows.value, threads.value, smem.value, blocks)


def score_frontier(weights: Dict[str, torch.Tensor], k_proj: torch.Tensor,
                   v: torch.Tensor, table: torch.Tensor, ids: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Scores [B, F] float32 of table rows ids [B, F] for each query's
    k_proj [B, L, DK] / v [B, L, DU]; -inf where valid is False.

    weights: `kernel_weights(fold_scorer(...), dt)` with dt = k_proj.dtype;
    table: [N, D] rows of dt, or packed int8 [N, D+4]. CUDA tensors launch
    the kernel (or raise); CPU tensors run the plain version."""
    if table.device.type == "cpu":
        return frontier_scorer_plain(weights, k_proj, v, table, ids, valid)
    if table.device.type != "cuda":
        raise ValueError(f"no frontier scorer for device {table.device}")
    _check(weights, k_proj, v, table, ids, valid)
    packed = table.dtype == torch.int8
    B, F = ids.shape
    out = torch.empty((B, F), dtype=torch.float32, device=table.device)
    if B == 0 or F == 0:
        return out
    args = _args(weights, k_proj, v, table, ids, valid, out)
    lib = _library()
    _init(_device_index(table))
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.nann_frontier_scorer(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError("frontier scorer launch failed: "
                           + lib.nann_cuda_error_string(err).decode())
    if packed:
        score_frontier.launches_int8 += 1
    else:
        score_frontier.launches += 1
    return out


score_frontier.launches = 0
score_frontier.launches_int8 = 0
