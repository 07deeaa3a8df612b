"""Bayesian semantic label fusion math.

Counterpart: kimera_semantics_tpu/ops/semantic.py (Likelihood,
make_likelihood, likelihood_matrix, dynamic_label_mask, informative,
normalize_probabilities)
and the likelihood cache
of kimera_semantics_tpu/ops/integrate.py (make_likelihood_cached).

Per measured label l != 0 the accumulators take sem_count += 1 and
sem_delta[l] += log(p) - log(1-p); the unknown label 0 is uninformative.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import SemanticConfig, UNKNOWN_LABEL


@dataclasses.dataclass(frozen=True)
class Likelihood:
    log_match: float
    log_nonmatch: float

    @property
    def delta(self) -> float:
        return self.log_match - self.log_nonmatch


def make_likelihood(cfg: SemanticConfig) -> Likelihood:
    p = cfg.semantic_measurement_probability
    if not (0.0 < p < 1.0):
        raise ValueError("semantic_measurement_probability must be in (0, 1)")
    lm, lnm = math.log(p), math.log(1.0 - p)
    if lm <= lnm:
        raise ValueError("match likelihood must exceed non-match likelihood")
    return Likelihood(log_match=lm, log_nonmatch=lnm)


_LIKELIHOOD_CACHE = {}


def likelihood_matrix(cfg: SemanticConfig, num_labels: int) -> np.ndarray:
    """The explicit L x L log-likelihood matrix, for tests and docs: log
    match on the diagonal, log non-match elsewhere, the unknown label's
    column zero."""
    lk = make_likelihood(cfg)
    mat = np.full((num_labels, num_labels), lk.log_nonmatch,
                  dtype=np.float32)
    np.fill_diagonal(mat, lk.log_match)
    mat[:, UNKNOWN_LABEL] = 0.0
    return mat


def make_likelihood_cached(cfg) -> Likelihood:
    """make_likelihood keyed by the measurement probability (`cfg` is a
    FusionConfig)."""
    key = cfg.semantic.semantic_measurement_probability
    if key not in _LIKELIHOOD_CACHE:
        _LIKELIHOOD_CACHE[key] = make_likelihood(cfg.semantic)
    return _LIKELIHOOD_CACHE[key]


def dynamic_label_mask(labels: torch.Tensor,
                       cfg: SemanticConfig) -> torch.Tensor:
    """False where a point carries a dynamic label (skipped entirely, TSDF
    included)."""
    ok = torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
    for dyn in cfg.dynamic_labels:
        ok = ok & (labels != dyn)
    return ok


def informative(labels: torch.Tensor) -> torch.Tensor:
    """Labels that move the posterior (the unknown column is zeroed)."""
    return labels != UNKNOWN_LABEL


def normalize_probabilities(logodds: torch.Tensor) -> torch.Tensor:
    """L2-normalization of the log-odds vector (last axis), the reference's
    normalizeProbabilities."""
    norm = torch.linalg.vector_norm(logodds, dim=-1, keepdim=True)
    return torch.where(norm > 0.0, logodds / torch.clamp(norm, min=1e-12),
                       logodds)
