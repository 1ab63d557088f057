"""Bloom-filter membership over (user, item) pairs (port of
``neurec_tpu/ops/bloom.py``).

Above the Trainer's exclusion-table budget the padded (U, L_max) positive
rows cost ``num_users * max_row`` ints, and the sampler's broadcast compare
grows with the longest row for every user. All train pairs are folded
instead into one flat bit array at ``BITS_PER_ENTRY`` bits a pair (~1 byte,
below the 4 bytes a pair of CSR), and membership is ``k`` byte gathers and
bit tests, independent of any row length.

The filter has no false negatives: a train positive is always flagged and
is sampled as a negative only when every bounded rejection round is
flagged and the round-0 draw, which is then kept, is a positive. A false
positive (~3.1% at 8 bits a pair and k = 3) only costs a rejection.

The host build is numpy (``np.bitwise_or.at``), a copy of the JAX
package's. The hashes are the JAX package's uint32 arithmetic (multiply,
xor, shift, add, each wrapping at 2^32), computed on the device in int64
with the high bits masked off after every product and sum, since torch's
uint32 support on CUDA is partial: the same slots as numpy's, bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_MIX_U1 = 0x9E3779B1  # 2^32 / golden ratio
_MIX_I1 = 0x85EBCA6B  # murmur3 fmix constants
_MIX_U2 = 0xC2B2AE35
_MIX_I2 = 0x27D4EB2F
_LOW32 = 0xFFFFFFFF

BITS_PER_ENTRY = 8
K_HASH = 5  # ~optimal FP at 8 bits/entry (m/n * ln2 = 5.5); FP ~2.2%


class PairBloom(NamedTuple):
    table: np.ndarray  # (m/8,) uint8 bit array
    n_bits: int        # m, a power of two
    k_hash: int = K_HASH  # hashes used at build time (probe with the same k)

    def nbytes(self) -> int:
        return self.table.nbytes


def _hashes_numpy(users, items, n_bits: int, k: int):
    """k slot indices per pair by double hashing, h_j = h1 + j*h2 (mod m),
    h2 odd, in uint32 (the JAX package's ``_hashes``)."""
    u = users.astype(np.uint32)
    i = items.astype(np.uint32)
    h1 = (u * np.uint32(_MIX_U1)) ^ (i * np.uint32(_MIX_I1))
    h1 = h1 ^ (h1 >> np.uint32(15))
    h2 = ((u * np.uint32(_MIX_U2)) ^ (i * np.uint32(_MIX_I2))) | np.uint32(1)
    mask = np.uint32(n_bits - 1)
    return [((h1 + np.uint32(j) * h2) & mask) for j in range(k)]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and a 32-bit ``c``, with
    no intermediate past 2^49: x's 16-bit halves times c, the high one's
    product shifted back after its high bits are dropped."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _LOW32


def hashes(users: torch.Tensor, items: torch.Tensor, n_bits: int, k: int):
    """``_hashes_numpy`` on the device: k int64 slot tensors of the
    broadcast shape of ``users`` and ``items``. Negative ids wrap as a cast
    to uint32 wraps them."""
    u = users.long() & _LOW32
    i = items.long() & _LOW32
    h1 = _mul32(u, _MIX_U1) ^ _mul32(i, _MIX_I1)
    h1 = h1 ^ (h1 >> 15)
    h2 = (_mul32(u, _MIX_U2) ^ _mul32(i, _MIX_I2)) | 1
    mask = n_bits - 1
    return [(h1 + j * h2) & mask for j in range(k)]


def build_pair_bloom(users, items, k_hash: int = K_HASH) -> PairBloom:
    """Host build from parallel (nnz,) user/item id arrays. At 8 bits an
    entry: k=5 -> FP ~2.2%, k=3 -> ~3.1%, k=2 -> ~4.9%; no false negatives
    at any k."""
    users = np.asarray(users)
    items = np.asarray(items)
    n = max(len(users), 1)
    n_bits = 1 << max(int(np.ceil(np.log2(n * BITS_PER_ENTRY))), 6)
    table = np.zeros(n_bits // 8, np.uint8)
    for h in _hashes_numpy(users, items, n_bits, k_hash):
        np.bitwise_or.at(table, (h >> 3).astype(np.int64), np.uint8(1) << (h & 7).astype(np.uint8))
    return PairBloom(table=table, n_bits=n_bits, k_hash=k_hash)


def is_positive_bloom(
    table: torch.Tensor,       # (m/8,) uint8 device copy of PairBloom.table
    n_bits: int,
    users: torch.Tensor,       # (B,)
    candidates: torch.Tensor,  # (B, ...) item ids
    k_hash: int = K_HASH,      # must equal the build-time k
) -> torch.Tensor:
    """True where (user, candidate) MAY be a train pair (no false
    negatives). k byte gathers and bit tests."""
    cand2d = candidates.reshape(candidates.shape[0], -1)
    hit = None
    for h in hashes(users[:, None], cand2d, n_bits, k_hash):
        byte = table[h >> 3].long()
        bit = (byte >> (h & 7)) & 1
        hit = bit if hit is None else (hit & bit)
    return (hit != 0).reshape(candidates.shape)


def select_first_nonmember(draws: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """(B,) the first draw of each row whose flag is False, the round-0
    draw where every round is flagged: the bounded-rejection contract of
    ``sample_negatives_bloom`` and the Trainer's whole-epoch pre-draw."""
    first = torch.argmax((~member).to(torch.uint8), dim=1, keepdim=True)
    return torch.gather(draws, 1, first)[:, 0]


def sample_negatives_bloom(
    generator: torch.Generator,
    users: torch.Tensor,   # (B,) user ids (exclusion = that user's pairs)
    table: torch.Tensor,
    n_bits: int,
    num_items: int,
    shape: tuple,
    num_rounds: int = 16,
    k_hash: int = K_HASH,
) -> torch.Tensor:
    """``ops.sampling.sample_negatives`` semantics (bounded rejection, the
    first unflagged draw, round-0 fallback) with Bloom membership: int32
    (B, *shape), work and memory independent of the longest user row."""
    B = users.shape[0]
    S = 1
    for d in shape:
        S *= d
    draws = torch.randint(0, num_items, (B, num_rounds * S), generator=generator, device=users.device,
                          dtype=torch.int32)
    member = is_positive_bloom(table, n_bits, users, draws, k_hash)
    ok = (~member).reshape(B, num_rounds, S).to(torch.uint8)
    first = torch.argmax(ok, dim=1, keepdim=True)
    chosen = torch.gather(draws.reshape(B, num_rounds, S), 1, first)[:, 0]
    return chosen.reshape((B,) + tuple(shape))
