"""The thesis's own workload: COSMO weather-prediction compound stencils
(NERO). A copy of ``repro/configs/cosmo_stencil.py``.

Not an LM architecture: a 3D grid consumed by ``repro_torch.kernels.hdiff``
/ ``repro_torch.kernels.vadvc`` and ``repro_torch.launch.weather_stencil``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StencilConfig:
    name: str = "cosmo-stencil"
    # COSMO production grid used in the thesis (Ch. 3): 256 x 256 x 64
    nx: int = 256
    ny: int = 256
    nz: int = 64
    dtype: str = "float32"
    # NERO-style tiling window (auto-tunable)
    tile_x: int = 64
    tile_y: int = 64
    halo: int = 2


def cosmo_grid() -> StencilConfig:
    return StencilConfig()


def smoke_grid() -> StencilConfig:
    return StencilConfig(name="cosmo-stencil-smoke", nx=16, ny=16, nz=4,
                         tile_x=8, tile_y=8)
