"""Model registry with stage transitions — the MLflow Model Registry role.

The reference registers the best HPO model and transitions it to Production, then
loads "the production model" by stage URI
(``Part 2 - Distributed Tuning & Inference/01_hyperopt_single_machine_model.py:
279-299``: ``register_model`` -> ``transition_model_version_stage(stage=
'Production')`` -> ``load_model('models:/<name>/production')``).

In-tree equivalent: ``<root>/<model_name>/v<N>/`` holds a copied model artifact dir
plus ``version.json`` (source run, stage, timestamps); stages are None / Staging /
Production / Archived. Transitioning a version to Production archives the previous
Production version (MLflow's ``archive_existing_versions`` behavior). Loading by
stage resolves to the newest version in that stage.
"""

from __future__ import annotations

import json
import os
import shutil
import time

STAGES = ("None", "Staging", "Production", "Archived")


class ModelRegistry:
    def __init__(self, root: str):
        self.root = root
        # root is created on first write (register) — read-only consumers
        # (the CLI) must not mutate the filesystem

    def _model_dir(self, name: str) -> str:
        return os.path.join(self.root, name)

    def _versions(self, name: str) -> list[int]:
        mdir = self._model_dir(name)
        if not os.path.isdir(mdir):
            return []
        return sorted(int(d[1:]) for d in os.listdir(mdir) if d.startswith("v"))

    def _version_meta(self, name: str, version: int) -> dict:
        with open(os.path.join(self._model_dir(name), f"v{version}", "version.json")) as f:
            return json.load(f)

    def _write_meta(self, name: str, version: int, meta: dict) -> None:
        with open(os.path.join(self._model_dir(name), f"v{version}", "version.json"), "w") as f:
            json.dump(meta, f, indent=2)

    # -- API -------------------------------------------------------------------
    def register(self, name: str, artifact_dir: str, run_id: str | None = None,
                 metrics: dict | None = None) -> int:
        """Register a packaged-model directory as a new version. Returns version."""
        versions = self._versions(name)
        v = (versions[-1] + 1) if versions else 1
        vdir = os.path.join(self._model_dir(name), f"v{v}")
        os.makedirs(os.path.dirname(vdir), exist_ok=True)
        shutil.copytree(artifact_dir, os.path.join(vdir, "model"))
        self._write_meta(name, v, {
            "name": name, "version": v, "stage": "None", "source_run_id": run_id,
            "metrics": metrics or {}, "created_unix": time.time(),
        })
        return v

    def transition(self, name: str, version: int, stage: str,
                   archive_existing: bool = True) -> None:
        if stage not in STAGES:
            raise ValueError(f"stage must be one of {STAGES}")
        if archive_existing and stage == "Production":
            for v in self._versions(name):
                meta = self._version_meta(name, v)
                if meta["stage"] == "Production" and v != version:
                    meta["stage"] = "Archived"
                    self._write_meta(name, v, meta)
        meta = self._version_meta(name, version)
        meta["stage"] = stage
        meta["transitioned_unix"] = time.time()
        self._write_meta(name, version, meta)

    def get_version(self, name: str, stage: str | None = None,
                    version: int | None = None) -> int:
        """Resolve a version number — by explicit version or newest in ``stage``."""
        if version is not None:
            return version
        candidates = self._versions(name)
        if stage is not None:
            candidates = [v for v in candidates
                          if self._version_meta(name, v)["stage"].lower() == stage.lower()]
        if not candidates:
            raise LookupError(f"no version of {name!r} in stage {stage!r}")
        return candidates[-1]

    def model_path(self, name: str, stage: str | None = None,
                   version: int | None = None) -> str:
        """Path to the packaged-model dir — the ``models:/<name>/<stage>`` URI role."""
        v = self.get_version(name, stage, version)
        return os.path.join(self._model_dir(name), f"v{v}", "model")

    def list_models(self) -> list[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(d for d in os.listdir(self.root)
                      if os.path.isdir(self._model_dir(d)))

    def list_versions(self, name: str) -> list[dict]:
        return [self._version_meta(name, v) for v in self._versions(name)]
