"""The towers' CAM injection point (``capture``/``feature_delta``).

A tower that takes ``capture`` and ``feature_delta`` exposes one spatial
activation grid (B, h, w, C): with ``capture=True`` it returns ``(pooled,
grid)``, and it adds ``feature_delta`` (the grid's shape) to the grid on the
way to its pooled output, so the gradient of a class score with respect to
a zero delta is the score's gradient with respect to the grid
(``skinjax_torch.xai.cam``). ``MultimodalModel`` finds these towers by their
signature.

``feature_delta`` may also be a ``DeltaProbe``: the grid it meets makes it a
zero fp32 delta of the grid's own shape that requires a gradient, so a CAM
runs one forward without knowing the grid's shape first.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


class DeltaProbe:
    """A ``feature_delta`` that takes the grid's shape: ``delta`` is None until
    a grid meets it, then the zero fp32 leaf that was added to that grid."""

    def __init__(self):
        self.delta: Optional[torch.Tensor] = None


def add_delta(grid: torch.Tensor, delta: Union[None, torch.Tensor, DeltaProbe]
              ) -> torch.Tensor:
    """``grid + delta`` in the grid's dtype, or the grid as it is."""
    if isinstance(delta, DeltaProbe):
        delta.delta = torch.zeros(grid.shape, dtype=torch.float32, device=grid.device,
                                  requires_grad=True)
        delta = delta.delta
    return grid if delta is None else grid + delta.to(grid.dtype)
