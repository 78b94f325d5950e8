from . import (  # noqa: F401
    resample,
    blockmap,
    cells,
    cow,
    geometry,
    grid,
    matchers,
    m3rsm,
    raycast,
    relocalize,
    scan,
    scoring,
)
