"""Loss configuration (port of `vslam_tpu.solvers.loss.LossConfig`).

Only the configuration is ported so far: the alignment slice runs the
quadratic loss ("None"). The robust weights and scalers, and the robust
entry of the whole-level GN kernel, are the next slice of the port
(ROADMAP.md); `alignment.ic.solve_level` raises NotImplementedError for any
other loss.
"""

from __future__ import annotations

import dataclasses

__all__ = ["LossConfig"]


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Mirrors the reference's `loss.*` parameter tree (NodeMapping.cpp:52-84);
    same fields and defaults as the JAX package."""

    function: str = "None"  # None | Tukey | Huber | tdistribution
    huber_c: float = 1.345
    tdistribution_v: float = 5.0
    scaler: str = "reference"  # reference | mad | mean
