"""Camera sensor-width database for EXIF-based focal estimation.

Reference: src/colmap/sensor/database.h:40 (CameraDatabase) +
specs.cc (~3.7k-entry make/model -> sensor width table). The table ships
as `camera_specs.csv` (factual spec data); the lookup mirrors the
reference QuerySensorWidth matching rules (sensor/database.cc:40-85):

  * make/model are cleaned of spaces/dashes and lowercased,
  * a duplicated make prefix is stripped from the model,
  * makes match by bidirectional substring containment,
  * models match by bidirectional substring containment; an exact model
    match wins immediately, otherwise the match must be UNIQUE.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

_CSV_PATH = os.path.join(os.path.dirname(__file__), "camera_specs.csv")


def _clean(s: str) -> str:
    return s.replace(" ", "").replace("-", "").lower()


@lru_cache(maxsize=1)
def load_specs() -> Dict[str, List[Tuple[str, float]]]:
    specs: Dict[str, List[Tuple[str, float]]] = {}
    with open(_CSV_PATH) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("make,"):
                continue
            parts = line.split(",")
            make = parts[0]
            width = float(parts[-1])
            model = ",".join(parts[1:-1])
            specs.setdefault(make, []).append((model, width))
    return specs


def query_sensor_width(make: str, model: str) -> Optional[float]:
    """Sensor width in mm, or None when no unique match exists."""
    cleaned_make = _clean(make)
    cleaned_model = _clean(model)
    if not cleaned_model:
        return None
    if not cleaned_make:
        # empty make would vacuously substring-match EVERY manufacturer
        # (the reference requires the make to actually match,
        # sensor/database.cc:40-85) — accept only a unique EXACT model
        # match across the whole table
        specs = load_specs()
        hits = [w for models in specs.values()
                for db_model, w in models if db_model == cleaned_model]
        return hits[0] if len(hits) == 1 else None
    cleaned_model = cleaned_model.replace(cleaned_make, "")

    specs = load_specs()
    matches = 0
    width = None
    for db_make, models in specs.items():
        if cleaned_make in db_make or db_make in cleaned_make:
            for db_model, w in models:
                if db_model in cleaned_model or cleaned_model in db_model:
                    width = w
                    if cleaned_model == db_model:
                        return w  # exact model match wins
                    matches += 1
                    if matches > 1:
                        break
    return width if matches == 1 else None
