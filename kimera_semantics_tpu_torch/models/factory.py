"""Integrator factory: string/enum -> integrator instance.

Counterpart: kimera_semantics_tpu/models/factory.py (create), the
reference's `SemanticTsdfIntegratorFactory::create`
(kimera_semantics/src/semantic_tsdf_integrator_factory.cpp:65-88): every
integrator shares one API, `integrate(grid, frame)`.
"""

from __future__ import annotations

from typing import Union

from ..config import FusionConfig, IntegratorType
from ..core.camera import PinholeIntrinsics
from .fast import FastSemanticTsdfIntegrator
from .merged import MergedSemanticTsdfIntegrator
from .projective import ProjectiveSemanticTsdfIntegrator
from .simple import SimpleSemanticTsdfIntegrator

_KINDS = {IntegratorType.FAST: FastSemanticTsdfIntegrator,
          IntegratorType.MERGED: MergedSemanticTsdfIntegrator,
          IntegratorType.SIMPLE: SimpleSemanticTsdfIntegrator,
          IntegratorType.PROJECTIVE: ProjectiveSemanticTsdfIntegrator}


def create(kind: Union[str, IntegratorType], cfg: FusionConfig,
           intr: PinholeIntrinsics, device="cuda"):
    """The integrator of `kind` on `device` (raises for CUDA without a
    card)."""
    if isinstance(kind, str):
        kind = IntegratorType(kind)
    if kind not in _KINDS:
        raise ValueError(f"unknown integrator type: {kind}")
    return _KINDS[kind](cfg, intr, device=device)
