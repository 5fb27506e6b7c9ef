"""Option management: dataclass config tree + .ini project files + argparse.

Port of colmap_tpu/controllers/option_manager.py: the same sections, the
same one-level flattening and collision rule, the same .ini layout, so a
project file written by either package reads into the other with the same
values. The JAX package's `[Mapper]` keys of its round catch-and-retry
(`max_round_retries`, `retry_cooldown_s`), which the port does not have,
are read and dropped with one log line naming them.

Reference: src/colmap/controllers/option_manager.h:61-124 (999 LoC over
boost::program_options). Every subsystem contributes an Options dataclass;
flags use the reference's dotted names (e.g.
--SiftExtraction.max_num_features) so command lines port across; project
.ini files round-trip (option_manager.h:116-118 Read/Write).
"""

from __future__ import annotations

import argparse
import configparser
import dataclasses
import logging
from typing import Any, Dict, Optional

from colmap_tpu_torch.controllers.feature_extraction import ImageReaderOptions
from colmap_tpu_torch.controllers.feature_matching import FeatureMatchingOptions
from colmap_tpu_torch.controllers.incremental_pipeline import IncrementalPipelineOptions
from colmap_tpu_torch.features.matching import MatchingOptions
from colmap_tpu_torch.features.pairing import SequentialPairingOptions
from colmap_tpu_torch.features.sift import SiftExtractionOptions
from colmap_tpu_torch.image.undistortion import UndistortCameraOptions
from colmap_tpu_torch.mvs.fusion import StereoFusionOptions
from colmap_tpu_torch.mvs.meshing import PoissonMeshingOptions
from colmap_tpu_torch.mvs.patch_match import PatchMatchOptions


_SECTIONS = {
    "ImageReader": ImageReaderOptions,
    "SiftExtraction": SiftExtractionOptions,
    "SiftMatching": MatchingOptions,
    "FeatureMatching": FeatureMatchingOptions,
    "SequentialMatching": SequentialPairingOptions,
    "Mapper": IncrementalPipelineOptions,
    "PatchMatchStereo": PatchMatchOptions,
    "StereoFusion": StereoFusionOptions,
    "PoissonMeshing": PoissonMeshingOptions,
    "UndistortCamera": UndistortCameraOptions,
}

_SCALARS = (int, float, bool, str)

# keys of the JAX package's project files that the port has no option for
_DROPPED = {"Mapper": ("max_round_retries", "retry_cooldown_s")}

logger = logging.getLogger("colmap_tpu_torch")


def _scalar_items(obj, _depth: int = 0):
    """Scalar option fields, flattening exactly ONE level of nested
    dataclasses (the reference exposes nested mapper options in the same
    flat namespace, e.g. --Mapper.init_min_num_inliers). Name collisions:
    parent scalars win, then the FIRST nested dataclass in field order."""
    out = []
    seen = set()
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, _SCALARS):
            out.append((f.name, v))
            seen.add(f.name)
    if _depth == 0:
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                for name, val in _scalar_items(v, _depth=1):
                    if name not in seen:
                        out.append((name, val))
                        seen.add(name)
    return out


def _apply_updates(obj, updates):
    """Apply flat-name updates; each key routes to AT MOST one target —
    the parent scalar if it exists, else the first nested dataclass (in
    field order) that has the field, mirroring the _scalar_items collision
    rule. A collision between two sub-option groups must not update both
    from one flag."""
    own = {f.name for f in dataclasses.fields(obj)
           if isinstance(getattr(obj, f.name), _SCALARS)}
    direct = {k: v for k, v in updates.items() if k in own}
    rest = {k: v for k, v in updates.items() if k not in own}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v) and rest:
            sub_fields = {g.name for g in dataclasses.fields(v)
                          if isinstance(getattr(v, g.name), _SCALARS)}
            sub = {k: val for k, val in rest.items() if k in sub_fields}
            if sub:
                direct[f.name] = _apply_updates(v, sub)
                for k in sub:  # consumed: later siblings never see it
                    del rest[k]
    if not direct:
        return obj
    if getattr(obj, "__dataclass_params__").frozen:
        return dataclasses.replace(obj, **direct)
    for k, v in direct.items():
        setattr(obj, k, v)
    return obj


class OptionManager:
    """Holds one instance of every subsystem's options + top-level paths."""

    def __init__(self):
        self.project_path: Optional[str] = None
        self.database_path: Optional[str] = None
        self.image_path: Optional[str] = None
        self.options: Dict[str, Any] = {
            name: cls() for name, cls in _SECTIONS.items()
        }

    def __getattr__(self, name):
        opts = self.__dict__.get("options", {})
        if name in opts:
            return opts[name]
        raise AttributeError(name)

    # -- argparse bridge -----------------------------------------------------

    def add_all_args(self, parser: argparse.ArgumentParser):
        parser.add_argument("--project_path", type=str, default=None)
        parser.add_argument("--database_path", type=str, default=None)
        parser.add_argument("--image_path", type=str, default=None)
        for section, obj in self.options.items():
            for name, val in _scalar_items(obj):
                arg = f"--{section}.{name}"
                if isinstance(val, bool):
                    parser.add_argument(arg, type=lambda v: v.lower() in
                                        ("1", "true", "yes"), default=None)
                else:
                    parser.add_argument(arg, type=type(val), default=None)

    def parse_args(self, args: argparse.Namespace):
        ns = vars(args)
        if ns.get("project_path"):
            self.read(ns["project_path"])
        for key in ("database_path", "image_path"):
            if ns.get(key) is not None:
                setattr(self, key, ns[key])
        for section in self.options:
            obj = self.options[section]
            updates = {name: ns.get(f"{section}.{name}")
                       for name, _ in _scalar_items(obj)
                       if ns.get(f"{section}.{name}") is not None}
            if updates:
                self.options[section] = _apply_updates(obj, updates)

    # -- ini project files -----------------------------------------------------

    def write(self, path: str):
        cp = configparser.ConfigParser()
        cp["root"] = {}
        if self.database_path:
            cp["root"]["database_path"] = self.database_path
        if self.image_path:
            cp["root"]["image_path"] = self.image_path
        for section, obj in self.options.items():
            cp[section] = {}
            for name, v in _scalar_items(obj):
                cp[section][name] = str(v)
        with open(path, "w") as fp:
            cp.write(fp)

    def read(self, path: str):
        cp = configparser.ConfigParser()
        if not cp.read(path):
            raise FileNotFoundError(path)
        if cp.has_option("root", "database_path"):
            self.database_path = cp["root"]["database_path"]
        if cp.has_option("root", "image_path"):
            self.image_path = cp["root"]["image_path"]
        dropped = [f"{section}.{name}"
                   for section, names in _DROPPED.items()
                   for name in names if cp.has_option(section, name)]
        if dropped:
            logger.info("%s: dropped options the port does not have: %s",
                        path, ", ".join(dropped))
        for section, obj in self.options.items():
            if not cp.has_section(section):
                continue
            updates = {}
            for name, cur in _scalar_items(obj):
                if not cp.has_option(section, name):
                    continue
                raw = cp[section][name]
                if isinstance(cur, bool):
                    updates[name] = raw.lower() in ("1", "true", "yes")
                elif isinstance(cur, int):
                    updates[name] = int(raw)
                elif isinstance(cur, float):
                    updates[name] = float(raw)
                elif isinstance(cur, str):
                    updates[name] = raw
            if updates:
                self.options[section] = _apply_updates(obj, updates)
