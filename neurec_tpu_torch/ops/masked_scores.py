"""K1: fused full-catalogue scoring + train-item masking.

Port of ``neurec_tpu/ops/pallas_kernels.py``. The mask builders give
bytes identical to the JAX ones:

* ``build_train_mask``: (B, I) int8 membership from padded train rows
  (pad ids >= I are dropped, ids in [-I, 0) wrap as JAX's ``.at[]``);
* ``pack_train_bits`` / ``pack_mask_bits``: bit-plane bytes — within item
  block ``blk`` of P items, item ``c*(P/8) + j`` sits in byte
  ``blk*(P/8) + j``, bit ``c``.

Two entry points share one CUDA kernel (``csrc/masked_scores.cu``),
templated on the mask format:

* ``masked_scores(u, items, train_rows)`` — K1's own contract (int8 mask
  built from the padded rows, as the JAX package does in XLA);
* ``masked_scores_bits(u, items, bits, width, num_items)`` — the same
  score-and-mask read from the bit-plane table of the evaluator's default
  ``bits`` tier (one global block of width W: item i in byte i % (W/8),
  bit i // (W/8)).

On CPU tensors both run their plain versions (``*_reference``). The kernel
has two arithmetic paths, chosen by the width alone (``k1_path``): f32 FMAs
on the CUDA cores, one chain per score over k in order, for
d <= ``K1_FMA_MAX_D``; above it a 3xTF32 split on the tensor cores (see the
source). ``round_tf32`` is the TF32 rounding the split applies to each
operand, for the tests of the split's numbers; ``fma_chain_scores`` is the
f32 path's chain a thread a score, for the tests of the f32 path's bits.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from neurec_tpu_torch.ops import _build

_NEG_INF = float("-inf")
# K1's item block in the JAX package (``masked_scores(block_items=512)``): its
# int8 mask spans num_items rounded up to it, so a negative id wraps into
# that width (into a pad column unless num_items is a multiple of 512)
_MASK_BLOCK = 512
# K1's f32 path takes d up to here: the kernel's entry picks its path from d
# against csrc/masked_scores.cu FMA_MAX_D, which this mirrors. At the
# evaluation shape the output's bytes bound K1; f32 FMAs stay under that
# time while 2 B I d / 67 TFLOP/s <= 4 B I / 3.35 TB/s, i.e. d <= 40, and at
# such d f32 is nearer the exact product than the split (22 of 24 bits)
K1_FMA_MAX_D = 40


def k1_path(d: int) -> str:
    """K1's arithmetic at width ``d``, as the kernel's entry chooses it:
    ``"fma"`` (f32 FMAs, one chain a score) for d <= ``K1_FMA_MAX_D``,
    ``"split"`` (3xTF32) above."""
    return "fma" if d <= K1_FMA_MAX_D else "split"


def _mask_width(num_items: int) -> int:
    return num_items + (-num_items) % _MASK_BLOCK


def wrap_ids(ids: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids, keep)`` as JAX's ``.at[ids]`` indexes an axis of ``n``: ids
    in [-n, 0) wrap to ``id + n``, and ``keep`` is False where the id lies
    outside [-n, n) (a scatter drops those)."""
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids)
    return ids, (ids >= 0) & (ids < n)


def build_train_mask(train_rows: torch.Tensor, num_items: int) -> torch.Tensor:
    """(B, num_items) int8 membership mask from padded train rows; ids in
    [-num_items, 0) wrap and ids outside [-num_items, num_items) are
    dropped, as the JAX package's ``.at[].set(mode="drop")``."""
    B = train_rows.shape[0]
    n = B * num_items
    rows, keep = wrap_ids(train_rows, num_items)
    # one fill over every slot, no boolean index (no host sync on the card)
    # and no sort (index_put_ sorts its indices on the card): a dropped id
    # sets the byte past the mask; every write is 1, so repeated ids give
    # the same bytes in any order
    flat = torch.zeros(n + 1, dtype=torch.int8, device=train_rows.device)
    slot = torch.arange(B, device=rows.device)[:, None] * num_items
    flat.index_fill_(0, torch.where(keep, slot + rows, n).reshape(-1), 1)
    return flat[:n].view(B, num_items)


def pack_mask_bits(mask: torch.Tensor, block_items: int) -> torch.Tensor:
    """(B, I_p) 0/1 mask -> (B, I_p/8) uint8 bit-plane bytes (I_p a
    multiple of ``block_items``)."""
    B, I_p = mask.shape
    m4 = mask.to(torch.uint8).reshape(B, I_p // block_items, 8, block_items // 8)
    bits = torch.zeros((B, I_p // block_items, block_items // 8), dtype=torch.uint8, device=mask.device)
    for plane in range(8):
        bits |= m4[:, :, plane, :] << plane
    return bits.reshape(B, I_p // 8)


def pack_train_bits(
    train_rows: torch.Tensor, num_items: int, block_items: int = 1024
) -> torch.Tensor:
    """(B, I_p/8) uint8 bit-plane-packed train mask, I_p = num_items padded
    to a multiple of ``block_items``."""
    I_p = num_items + (-num_items) % block_items
    return pack_mask_bits(build_train_mask(train_rows, I_p), block_items)


def bits_expand(bits: torch.Tensor, width: int) -> torch.Tensor:
    """(B, width/8) uint8 -> (B, width) 0/1 membership, plane-major."""
    planes = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return ((bits[:, None, :] >> planes[None, :, None]) & 1).reshape(bits.shape[0], width)


def round_tf32_reference(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 as K1 rounds its operands (nearest, ties away from zero,
    10 mantissa bits), returned as f32: add half of the dropped 13 bits'
    range to the magnitude's bits and clear them. A carry rounds the largest
    finite floats to inf and the largest subnormals up to normals. That is
    ``cvt.rna.tf32.f32`` on every value but NaN: inf and NaN pass through,
    where the instruction clears a NaN's low 13 payload bits."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """TF32 rounding of an f32 tensor; on a CUDA tensor the card's own
    ``cvt.rna.tf32.f32``, which K1's integer rounding reproduces on every
    value but NaN (see ``round_tf32_reference``)."""
    if x.dtype != torch.float32:
        raise TypeError("round_tf32 takes float32, got %s" % x.dtype)
    if x.device.type == "cpu":
        return round_tf32_reference(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    lib = _build.load("masked_scores", x.device)
    fn = lib.neurec_round_tf32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), out.data_ptr(), x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "round_tf32")
    _build.LAUNCHES["round_tf32"] += 1
    return out


def fma_chain_scores_reference(u: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """(B, I) unmasked scores, each one fmaf chain from 0 over k in order as
    K1's f32 path forms it, emulated in f64: a step's product is exact in
    f64 and its sum is rounded to f64, then to f32. That is fmaf's one
    rounding except where the f64 sum lands on the midpoint of two floats
    (double rounding, ~2^-29 of steps), so the card's chain is the oracle of
    the f32 path's bits, this its plain version."""
    u64, i64 = u.double(), items.double()
    acc = torch.zeros((u.shape[0], items.shape[0]), dtype=torch.float32, device=u.device)
    for k in range(u.shape[1]):
        acc = (u64[:, k, None] * i64[None, :, k] + acc.double()).float()
    return acc


def fma_chain_scores(u: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """(B, I) f32 u @ items^T, each score one fmaf chain from 0 over k in
    order, a thread a score on the card: the f32 path's arithmetic without
    its tiles, copies or mask, which a test holds K1's f32 path to bit for
    bit. Never called by the wrappers."""
    _check_factors(u, items, items.shape[0])
    if u.device.type == "cpu":
        return fma_chain_scores_reference(u, items)
    u, items = u.contiguous(), items.contiguous()
    out = torch.empty((u.shape[0], items.shape[0]), dtype=torch.float32, device=u.device)
    lib = _build.load("masked_scores", u.device)
    fn = lib.neurec_fma_chain
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    with torch.cuda.device(u.device):
        code = fn(u.data_ptr(), items.data_ptr(), out.data_ptr(), u.shape[0], items.shape[0], u.shape[1],
                  torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(lib, code, "fma_chain")
    _build.LAUNCHES["fma_chain"] += 1
    return out


def masked_scores_reference(
    u: torch.Tensor, items: torch.Tensor, train_rows: torch.Tensor
) -> torch.Tensor:
    scores = torch.matmul(u, items.T)
    num_items = items.shape[0]
    mask = build_train_mask(train_rows, _mask_width(num_items))[:, :num_items]
    return torch.where(mask != 0, _NEG_INF, scores)


def masked_scores_bits_reference(
    u: torch.Tensor, items: torch.Tensor, bits: torch.Tensor, width: int, num_items: int
) -> torch.Tensor:
    scores = torch.matmul(u, items[:num_items].T)
    mask = bits_expand(bits, width)[:, :num_items]
    return torch.where(mask != 0, _NEG_INF, scores)


def _check_factors(u: torch.Tensor, items: torch.Tensor, num_items: int) -> None:
    if u.dtype != torch.float32 or items.dtype != torch.float32:
        raise TypeError("masked scores take float32 u and items, got %s, %s" % (u.dtype, items.dtype))
    if u.dim() != 2 or items.dim() != 2 or u.shape[1] != items.shape[1]:
        raise ValueError("u (B, d) and items (I, d) expected, got %s, %s"
                         % (tuple(u.shape), tuple(items.shape)))
    if items.shape[0] < num_items:
        raise ValueError("items has %d rows, fewer than num_items=%d" % (items.shape[0], num_items))
    if items.device != u.device:
        raise ValueError("u on %s, items on %s" % (u.device, items.device))


def aligned16(u: torch.Tensor, items: torch.Tensor) -> bool:
    """Whether K1 copies its operands 16 bytes at a time: both bases
    16-byte aligned. The f32 path then copies a tile's rows (512 d bytes a
    user tile and 480 d an item tile from the base) by 16-byte copies at
    every d, ragged d included; the split needs d % 4 == 0 as well (16-byte
    rows). 4-byte copies otherwise."""
    return u.data_ptr() % 16 == 0 and items.data_ptr() % 16 == 0


def _launch(u, items, mask, num_items, mask_stride, plane_bytes, mode):
    """Run the K1 kernel; ``mask`` is a (B, mask_stride) uint8/int8 tensor."""
    if u.device.type != "cuda":
        raise ValueError("the masked-scores kernel runs on cuda, not %s" % u.device)
    if mask.device != u.device or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous tensor on %s" % u.device)
    B, d = u.shape
    u, items = u.contiguous(), items.contiguous()
    out = torch.empty((B, num_items), dtype=torch.float32, device=u.device)
    aligned = int(aligned16(u, items))
    lib = _build.load("masked_scores", u.device)
    fn = lib.neurec_masked_scores
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(u.device):
        code = fn(
            u.data_ptr(), items.data_ptr(), mask.data_ptr(), out.data_ptr(),
            B, num_items, d, mask_stride, plane_bytes, mode, aligned,
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    _build.check(lib, code, "masked_scores")
    _build.LAUNCHES["masked_scores"] += 1
    return out


def masked_scores(
    u: torch.Tensor, items: torch.Tensor, train_rows: torch.Tensor
) -> torch.Tensor:
    """(B, I) f32 scores u @ items^T with each user's train items at -inf.

    ``train_rows`` (B, L) int holds each user's train items, padded with
    ids >= I.
    """
    num_items = items.shape[0]
    _check_factors(u, items, num_items)
    if train_rows.dim() != 2 or train_rows.shape[0] != u.shape[0]:
        raise ValueError("train_rows must be (B, L), got %s" % (tuple(train_rows.shape),))
    if u.device.type == "cpu":
        return masked_scores_reference(u, items, train_rows)
    mask = build_train_mask(train_rows, _mask_width(num_items))
    return _launch(u, items, mask, num_items, mask.shape[1], 1, mode=0)


def masked_scores_bits(
    u: torch.Tensor, items: torch.Tensor, bits: torch.Tensor, width: int, num_items: int
) -> torch.Tensor:
    """(B, num_items) f32 scores with the bit-plane mask ``bits``
    (B, width/8) uint8 applied; ``items`` needs >= num_items rows."""
    _check_factors(u, items, num_items)
    if width % 8 or num_items > width:
        raise ValueError("width must be a multiple of 8 and >= num_items")
    if bits.dtype != torch.uint8 or tuple(bits.shape) != (u.shape[0], width // 8):
        raise ValueError("bits must be (B, width/8) uint8, got %s %s" % (bits.dtype, tuple(bits.shape)))
    if u.device.type == "cpu":
        return masked_scores_bits_reference(u, items, bits, width, num_items)
    return _launch(u, items, bits, num_items, width // 8, width // 8, mode=1)
