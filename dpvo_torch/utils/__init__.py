"""Timing and coordinate-grid helpers (dpvo_tpu/utils' exports)."""
from .timing import Timer, all_times
from .grids import (coords_grid, coords_grid_with_index, flatmeshgrid,
                    all_pairs_exclusive, set_depth)

__all__ = ["Timer", "all_times", "coords_grid", "coords_grid_with_index",
           "flatmeshgrid", "all_pairs_exclusive", "set_depth"]
