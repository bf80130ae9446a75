"""Mesh construction (thin re-export).

The implementation lives in :mod:`repro_torch.parallel.meshes`; this
module keeps the ``launch.mesh`` import path of the reference
(``repro/launch/mesh.py``) for launchers and scripts.
"""
from __future__ import annotations

from repro_torch.parallel.meshes import (  # noqa: F401
    make_abstract_mesh,
    make_host_mesh,
    make_mesh,
    make_production_mesh,
    make_serving_mesh,
    parse_mesh,
)
