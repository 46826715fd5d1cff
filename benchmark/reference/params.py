"""The map parameters as the plain reference reads them.

A configuration file's ``map_config`` block (the upstream ``Parameter``
fields, as ``benchmark/configs/*.json`` hold them) with the derived sizes
the update needs: the grid's side, the ray step, the polar cube's bins and
the overlap window. Written from the upstream formulas, not imported from
the program.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

__all__ = ["Params"]


class Params:
    """Read-only view of a ``map_config`` mapping with the derived sizes."""

    def __init__(self, fields: Mapping[str, Any]):
        self._fields = dict(fields)

    def __getattr__(self, name: str) -> Any:
        try:
            return self._fields[name]
        except KeyError:
            raise AttributeError(name) from None

    @property
    def cell_n(self) -> int:
        """Cells per side, the one-cell border included."""
        return int(round(self.map_length / self.resolution)) + 2

    @property
    def ray_step(self) -> float:
        return self.resolution / math.sqrt(2.0)

    @property
    def n_ray_steps(self) -> int:
        return max(int(math.ceil(self.max_ray_length / self.ray_step)) - 1, 0)

    @property
    def azimuth_bins(self) -> int:
        if self.raycast_azimuth_bins > 0:
            return self.raycast_azimuth_bins
        return min(512, 1 << max(12 * self.cell_n - 1, 1).bit_length())

    @property
    def overlap_cell_range(self):
        cell_range = int(self.overlap_clear_range_xy / self.resolution)
        cell_range = max(0, min(cell_range, self.cell_n))
        return self.cell_n // 2 - cell_range // 2, self.cell_n // 2 + cell_range // 2

    def cleanup_mode(self) -> str:
        """The visibility cleanup the configuration runs: ``raycast_mode``
        with ``auto`` resolved by the work rule (the exact march only for
        short rays whose march is far below the cube)."""
        mode = self.raycast_mode
        if mode != "auto":
            return mode
        cube = self.azimuth_bins * (self.n_ray_steps + 2) * self.raycast_elevation_bins
        march = self.n_ray_steps * self.max_points
        return "exact" if self.n_ray_steps <= 12 and march * 8 < cube else "polar"
