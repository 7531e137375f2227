"""Loop closure: appearance-based detection and geometric verification.

Port of :mod:`thor_slam_tpu.engine.loop`.

* :func:`find_candidate` votes for the place-database entry that shares
  the most descriptors with the query: exact integer Hamming distances
  (the port's popcount), blocked over entries so the (N, K*N) distance
  matrix never exists whole. Blocks holding no eligible entry are skipped;
  their votes are -1 as in the reference.
* :func:`verify_candidate` matches the query against the candidate's
  descriptors and runs the batched RANSAC PnP with 48 hypotheses; a loop
  is accepted on a strong inlier consensus. Its hypothesis draws are an
  argument (``uniforms``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from thor_slam_tpu_torch.engine import pnp
from thor_slam_tpu_torch.ops import match as match_ops

NUM_HYPOTHESES = 48


class LoopCandidate(NamedTuple):
    """Best entry index, its votes, and the (K,) votes of every entry
    (-1 where not eligible)."""

    keyframe: torch.Tensor
    votes: torch.Tensor
    all_votes: torch.Tensor


def _hamming_words(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (M, 8) int32 words -> (N, M) int64 distances, one word at a
    time so the transient stays (N, M)."""
    ham = None
    for w in range(q.shape[-1]):
        bits = match_ops.popcount32(q[:, None, w].long() ^ d[None, :, w].long())
        ham = bits if ham is None else ham + bits
    return ham


def find_candidate(
    query_desc: torch.Tensor,
    query_valid: torch.Tensor,
    db_desc: torch.Tensor,
    db_valid: torch.Tensor,
    db_mask: torch.Tensor,
    match_threshold: int = 48,
    block: int = 32,
) -> LoopCandidate:
    """Vote for the database entry that shares the most descriptors.

    Args:
        query_desc: (N, 8) int32 descriptor words of the query.
        query_valid: (N,) bool.
        db_desc: (K, N, 8) int32 database words; an entry is one
            (keyframe, camera) signature.
        db_valid: (K, N) bool.
        db_mask: (K,) float 1/0, eligible entries (read on the host to
            skip empty blocks).
        match_threshold: Hamming distance at or under which a query
            descriptor's best match in an entry votes for it.
        block: Entries per distance block.
    """
    k, n, _ = db_desc.shape
    while k % block:
        block //= 2
    eligible = (db_mask.detach().cpu().reshape(k // block, block) > 0).any(1).tolist()
    votes = torch.full((k,), -1, dtype=torch.int64, device=db_desc.device)
    for bi, any_eligible in enumerate(eligible):
        if not any_eligible:
            continue
        rows = slice(bi * block, (bi + 1) * block)
        ham = _hamming_words(query_desc, db_desc[rows].reshape(block * n, -1))  # (N, B*N)
        gate = query_valid[:, None] & db_valid[rows].reshape(1, block * n)
        ham = torch.where(gate, ham, 1 << 30)
        best_per_entry = torch.amin(ham.reshape(n, block, n), -1)  # (N, B)
        votes[rows] = torch.sum(best_per_entry <= match_threshold, 0)
    votes = torch.where(db_mask.to(votes.device) > 0, votes, -1)
    best = torch.argmax(votes)
    return LoopCandidate(keyframe=best, votes=votes[best], all_votes=votes)


class LoopVerification(NamedTuple):
    """Geometric check of a loop candidate: ``accepted``, the query body
    pose in the candidate's world frame (``body_t_candidate``, 4x4),
    ``num_inliers``, the inlier ``rms_error`` and the solve's (6, 6)
    tangent ``covariance`` (the constraint's own noise floor)."""

    accepted: torch.Tensor
    body_t_candidate: torch.Tensor
    num_inliers: torch.Tensor
    rms_error: torch.Tensor
    covariance: torch.Tensor


def verify_candidate(
    cand_lm_w: torch.Tensor,
    cand_lm_valid: torch.Tensor,
    cand_desc: torch.Tensor,
    query_obs_norm: torch.Tensor,
    query_desc: torch.Tensor,
    query_valid: torch.Tensor,
    cam_rot: torch.Tensor,
    cam_trans: torch.Tensor,
    init_body_t_world: torch.Tensor,
    uniforms: torch.Tensor,
    min_inliers: int = 40,
    inlier_threshold: float = 0.01,
) -> LoopVerification:
    """Descriptor-match the query against the candidate, then RANSAC PnP.

    Single-camera slices: the candidate's (N, 3) world landmarks, (N,)
    validity and (N, 8) words; the query's (N, 2) normalized observations,
    words and validity; the query camera's cam_T_body ``cam_rot`` (3, 3)
    and ``cam_trans`` (3,); ``uniforms``, the (48, N) hypothesis draws in
    [0, 1).
    """
    m = match_ops.match_descriptors(query_desc, query_valid, cand_desc, cand_lm_valid, ratio=0.9)
    lm = cand_lm_w[m.idx]
    lm_ok = cand_lm_valid[m.idx] & m.valid
    n = query_desc.shape[0]
    result = pnp.ransac_pnp(
        lm, query_obs_norm, lm_ok,
        cam_rot.expand(n, 3, 3), cam_trans.expand(n, 3), init_body_t_world,
        num_hypotheses=NUM_HYPOTHESES, sample_size=6, inlier_threshold=inlier_threshold,
        uniforms=uniforms,
    )
    return LoopVerification(
        accepted=result.num_inliers >= min_inliers,
        body_t_candidate=result.body_t_world,
        num_inliers=result.num_inliers,
        rms_error=result.rms_error,
        covariance=result.covariance,
    )
