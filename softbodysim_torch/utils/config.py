"""SolverParams <-> JSON: the framework's config surface.

The counterpart of ``softbodysim_tpu/utils/config.py``: the same fields in
the same order, so both packages write the same JSON and read each
other's.
"""

from __future__ import annotations

import dataclasses
import json

from ..core.state import SolverParams


def params_to_json(params: SolverParams, path: str = None) -> str:
    d = dataclasses.asdict(params)
    d["gravity"] = list(d["gravity"])
    d["ground_point"] = list(d["ground_point"])
    d["ground_normal"] = list(d["ground_normal"])
    s = json.dumps(d, indent=2)
    if path:
        with open(path, "w") as f:
            f.write(s)
    return s


def params_from_json(src: str) -> SolverParams:
    """src: a JSON string or the path of a JSON file."""
    if src.strip().startswith("{"):
        d = json.loads(src)
    else:
        with open(src) as f:
            d = json.load(f)
    for key in ("gravity", "ground_point", "ground_normal"):
        if key in d:
            d[key] = tuple(d[key])
    known = {f.name for f in dataclasses.fields(SolverParams)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown SolverParams fields: {sorted(unknown)}")
    return SolverParams(**d)
