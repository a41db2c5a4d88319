"""JSON IO: tracks, vehicles, and the racing-line → NMPC artifact schemas.

Schemas are byte-compatible with the reference so artifacts interoperate both
ways (SURVEY.md §2.2):

* track:      {"name", "left": {"x", "y"}, "right": {"x", "y"}}
* vehicle:    tbr18-style {"name","mass","frictionCoefficient","engineMap"}
              or MX5-style JSON-with-comments (Pacejka parameters)
* artifacts:  path/left/right = {"name", "path": {"x","y"}},
              widths = {"name", "width": [...]},
              velocities = {"name", "velocities": [...]}

Deliberate fix vs the reference: artifact files are joined with os.path.join
instead of a literal backslash f-string (reference src/utils.py:117,126,135
writes files named `dir\name.json` on Linux).
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

#: data/ shipped with this repo (tracks + vehicles; L0 of the layer map).
PACKAGE_DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "data"
)

#: Candidate data roots, first match wins: explicit override, the working
#: directory (for artifacts generated in-place), then the data shipped with
#: the framework. The reference checkout is NOT searched — golden-parity
#: tests point at it explicitly via their own fixture path.
_DATA_DIR_CANDIDATES = (
    os.environ.get("LTO_DATA_DIR"),
    os.path.join(os.getcwd(), "data"),
    PACKAGE_DATA_DIR,
)


def data_dir_candidates() -> list[str]:
    out = []
    for c in _DATA_DIR_CANDIDATES:
        if c and os.path.isdir(c) and c not in out:
            out.append(c)
    return out


def default_data_dir() -> str:
    cands = data_dir_candidates()
    if cands:
        return cands[0]
    raise FileNotFoundError(
        "No data directory found; set LTO_DATA_DIR or create ./data "
        "(expected subdirs tracks/ and vehicles/)"
    )


def _resolve(kind: str, name_or_path: str) -> str:
    """Accept a JSON path or a bare name; search EVERY data root (a local
    ./data holding only generated artifacts must not shadow the root that
    ships the tracks/vehicles)."""
    if os.path.isfile(name_or_path):
        return name_or_path
    for root in data_dir_candidates():
        cand = os.path.join(root, kind, f"{name_or_path}.json")
        if os.path.isfile(cand):
            return cand
    raise FileNotFoundError(f"{kind[:-1]} not found: {name_or_path}")


def resolve_track(name_or_path: str) -> str:
    """Accept either a JSON path or a bare track name like 'buckmore'."""
    return _resolve("tracks", name_or_path)


def resolve_vehicle(name_or_path: str) -> str:
    return _resolve("vehicles", name_or_path)


def strip_json_comments(text: str) -> str:
    """Remove // line and /* block */ comments (MX5.json uses both)."""
    text = re.sub(r"//.*", "", text)
    return re.sub(r"/\*.*?\*/", "", text, flags=re.DOTALL)


def load_jsonc(path: str) -> dict:
    with open(path, "r") as f:
        return json.loads(strip_json_comments(f.read()))


def load_track_json(path: str):
    """Return (name, left(2,n), right(2,n)) cone arrays (float64 numpy)."""
    data = load_jsonc(path)
    left = np.asarray([data["left"]["x"], data["left"]["y"]], dtype=np.float64)
    right = np.asarray([data["right"]["x"], data["right"]["y"]], dtype=np.float64)
    return data["name"], left, right


def save_path_json(dirpath: str, x, y, name: str) -> str:
    os.makedirs(dirpath, exist_ok=True)
    out = os.path.join(dirpath, f"{name}.json")
    with open(out, "w") as f:
        json.dump({"name": name, "path": {"x": np.asarray(x).tolist(), "y": np.asarray(y).tolist()}}, f, indent=4)
    return out


def save_widths_json(dirpath: str, widths, name: str = "widths") -> str:
    os.makedirs(dirpath, exist_ok=True)
    out = os.path.join(dirpath, f"{name}.json")
    with open(out, "w") as f:
        json.dump({"name": name, "width": np.asarray(widths).tolist()}, f, indent=4)
    return out


def save_velocities_json(dirpath: str, velocities, name: str = "velocities") -> str:
    os.makedirs(dirpath, exist_ok=True)
    out = os.path.join(dirpath, f"{name}.json")
    with open(out, "w") as f:
        json.dump({"name": name, "velocities": np.asarray(velocities).tolist()}, f, indent=4)
    return out


def load_artifact(path: str):
    """Load one artifact JSON: returns (x, y) for paths, or a 1-D array."""
    with open(path, "r") as f:
        data = json.load(f)
    if "path" in data:
        return np.asarray(data["path"]["x"]), np.asarray(data["path"]["y"])
    if "width" in data:
        return np.asarray(data["width"])
    if "velocities" in data:
        return np.asarray(data["velocities"])
    raise ValueError(f"unrecognised artifact schema in {path}")


def artifact_dir(base: str, vehicle_name: str, track_name: str, method: str) -> str:
    """data/plots/<vehicle>/<track>/<method>/ — reference src/__main__.py:178-184."""
    return os.path.join(base, "plots", vehicle_name, track_name, method)


def find_artifact_dir(
    vehicle_name: str,
    track_name: str,
    method: str,
    base: str | None = None,
    method_fallbacks: tuple = (),
):
    """Locate an artifact set, searching every data root unless `base` is
    explicit.  Returns (base_dir, method) or raises with the searched roots.
    `method_fallbacks` are tried (across all roots) after the primary method —
    e.g. laptime→compromise, the reference quirk at src/mpc.py:55-57."""
    roots = [base] if base else data_dir_candidates()
    if not roots:
        raise FileNotFoundError(
            "No data directory found; set LTO_DATA_DIR or create ./data "
            "(expected subdirs tracks/, vehicles/ and plots/)"
        )
    for m in (method, *method_fallbacks):
        for root in roots:
            if os.path.isdir(artifact_dir(root, vehicle_name, track_name, m)):
                return root, m
    raise FileNotFoundError(
        f"no racing-line artifacts for {vehicle_name}/{track_name}/{method} "
        f"under {roots}; run the racing-line CLI first"
    )
