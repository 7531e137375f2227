"""Binary descriptor matching: Hamming distance, mutual NN, ratio test.

Port of :mod:`thor_slam_tpu.ops.match`. Distances are an exact SWAR
popcount over the XOR of the packed words, computed in int64 (the words
are int32 bit patterns; see :mod:`thor_slam_tpu_torch.ops.brief`). The
reference's +-1 matmul form is a TPU workaround and gives the same
integers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_INF = 1e9
_LOW32 = 0xFFFFFFFF


class Matches(NamedTuple):
    """Matches from set A into set B (capacity len(A)).

    Attributes:
        idx: (..., N) int64 index into B per A slot.
        distance: (..., N) float32 Hamming distance.
        valid: (..., N) bool confident mutual match.
    """

    idx: torch.Tensor
    distance: torch.Tensor
    valid: torch.Tensor


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Population count of the low 32 bits of int64 values (SWAR)."""
    v = v & _LOW32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 8) x (..., M, 8) packed words -> (..., N, M) float32 distances."""
    a = desc_a.long()[..., :, None, :]
    b = desc_b.long()[..., None, :, :]
    return popcount32(a ^ b).sum(-1).float()


def match_descriptors(
    desc_a: torch.Tensor,
    valid_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
    max_distance: float = 64.0,
    ratio: float = 0.9,
    allowed: torch.Tensor | None = None,
) -> Matches:
    """Mutual nearest-neighbour matching with Lowe ratio and distance gates.

    Batched over leading dims (cameras): ``desc_a`` (..., N, 8),
    ``valid_a`` (..., N), ``desc_b`` (..., M, 8), ``valid_b`` (..., M),
    ``allowed`` optional (..., N, M) guided-matching gate.
    """
    dist = hamming_matrix(desc_a, desc_b)
    gate = valid_a[..., :, None] & valid_b[..., None, :]
    if allowed is not None:
        gate = gate & allowed
    dist = torch.where(gate, dist, _INF)

    best = torch.amin(dist, -1)
    best_idx = torch.argmin(dist, -1)  # first index of the minimum
    iota_b = torch.arange(dist.shape[-1], device=dist.device)
    second = torch.amin(torch.where(iota_b == best_idx[..., None], _INF, dist), -1)

    b_best_of_a = torch.argmin(dist, -2)  # (..., M)
    mutual = torch.gather(b_best_of_a, -1, best_idx) == torch.arange(
        dist.shape[-2], device=dist.device
    )
    ok = (best <= max_distance) & (best < ratio * torch.clamp(second, min=1e-6)) & mutual & valid_a
    return Matches(idx=best_idx, distance=best, valid=ok)
