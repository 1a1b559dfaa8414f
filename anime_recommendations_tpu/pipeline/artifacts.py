"""Local versioned artifact store.

Replaces the reference's W&B artifact bus (every step does wandb.init +
use_artifact + log_artifact + .wait(), round-tripping every cross-step
datum through W&B cloud storage — SURVEY.md §1). Same naming contract:
artifacts are addressed as ``name``, ``name:vN`` or ``name:latest``
(config.yaml:24-42 pins versions exactly this way), carry a metadata dict
and a type, and are immutable once logged.

Layout:  <root>/<name>/v<N>/{files..., .metadata.json}
"""

from __future__ import annotations

import json
import re
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Any


_SAFE = re.compile(r"[^A-Za-z0-9._-]+")


def _safe_dirname(name: str) -> str:
    return _SAFE.sub("_", name)


@dataclass(frozen=True)
class ArtifactHandle:
    name: str
    version: int
    dir: Path
    type: str
    metadata: dict[str, Any]

    @property
    def ref(self) -> str:
        return f"{self.name}:v{self.version}"

    def file(self, filename: str | None = None) -> Path:
        """Path of a contained file; with no argument, the single file
        (reference artifact.file() semantics)."""
        files = self.files()
        if filename is None:
            if len(files) != 1:
                raise ValueError(
                    f"{self.ref} holds {len(files)} files; specify one of "
                    f"{[f.name for f in files]}"
                )
            return files[0]
        path = self.dir / filename
        if not path.exists():
            raise FileNotFoundError(f"{self.ref} has no file {filename!r}")
        return path

    def files(self) -> list[Path]:
        return sorted(
            p for p in self.dir.iterdir() if p.name != ".metadata.json"
        )


class ArtifactStore:
    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    # ---- write ----------------------------------------------------------------

    def log(
        self,
        name: str,
        files: dict[str, str | Path] | None = None,
        metadata: dict[str, Any] | None = None,
        type: str = "file",
        description: str = "",
    ) -> ArtifactHandle:
        """Create the next version of ``name`` from existing files on disk."""
        art_dir = self.root / _safe_dirname(name)
        art_dir.mkdir(parents=True, exist_ok=True)
        version = self._next_version(art_dir)
        vdir = art_dir / f"v{version}"
        vdir.mkdir()
        for fname, src in (files or {}).items():
            shutil.copy2(src, vdir / fname)
        meta = {
            "name": name,
            "version": version,
            "type": type,
            "description": description,
            "metadata": metadata or {},
        }
        (vdir / ".metadata.json").write_text(json.dumps(meta, indent=2, default=str))
        return self._handle(name, version, vdir)

    def log_frame(self, name: str, frame, filename: str | None = None,
                  index: bool = False, **kwargs) -> ArtifactHandle:
        """Convenience: write a DataFrame as <filename or name>, a pandas
        pickle for ``.pkl`` names (the pipeline's own inter-step frames,
        dtypes kept, nothing beyond pandas needed) and CSV otherwise."""
        filename = filename or name
        tmp = self.root / f".tmp_{_safe_dirname(filename)}"
        if filename.endswith(".pkl"):
            frame.to_pickle(tmp)
        else:
            frame.to_csv(tmp, index=index)
        try:
            return self.log(name, files={filename: tmp}, **kwargs)
        finally:
            tmp.unlink(missing_ok=True)

    # ---- read -----------------------------------------------------------------

    def get(self, ref: str) -> ArtifactHandle:
        """Resolve ``name``, ``name:vN`` or ``name:latest``."""
        if ":" in ref:
            name, ver = ref.rsplit(":", 1)
        else:
            name, ver = ref, "latest"
        art_dir = self.root / _safe_dirname(name)
        if not art_dir.exists():
            raise FileNotFoundError(f"No artifact named {name!r} in {self.root}")
        if ver == "latest":
            version = self._latest_version(art_dir)
            if version is None:
                raise FileNotFoundError(f"Artifact {name!r} has no versions")
        else:
            if not ver.startswith("v"):
                raise ValueError(f"Bad version {ver!r} (want vN or latest)")
            version = int(ver[1:])
        vdir = art_dir / f"v{version}"
        if not vdir.exists():
            raise FileNotFoundError(f"{name}:v{version} does not exist")
        return self._handle(name, version, vdir)

    def names(self) -> list[str]:
        """All artifact names in the store (original, un-sanitized), from
        each artifact's latest version metadata.

        A version directory left without .metadata.json by a crashed or
        partial log must not break enumeration for every caller: walk back
        to the newest version that HAS metadata, else fall back to the
        sanitized directory name (mirroring exists()'s tolerance)."""
        out = []
        for art_dir in sorted(self.root.iterdir()):
            if not art_dir.is_dir() or art_dir.name.startswith("."):
                continue
            v = self._latest_version(art_dir)
            if v is None:
                continue
            name = None
            for ver in range(v, -1, -1):
                meta_path = art_dir / f"v{ver}" / ".metadata.json"
                try:
                    name = json.loads(meta_path.read_text())["name"]
                    break
                except (FileNotFoundError, json.JSONDecodeError, KeyError):
                    continue
            out.append(name if name is not None else art_dir.name)
        return out

    def exists(self, ref: str) -> bool:
        try:
            self.get(ref)
            return True
        except (FileNotFoundError, ValueError):
            return False

    def versions(self, name: str) -> list[int]:
        art_dir = self.root / _safe_dirname(name)
        if not art_dir.exists():
            return []
        return sorted(
            int(p.name[1:]) for p in art_dir.iterdir()
            if p.is_dir() and p.name.startswith("v")
        )

    # ---- internals ------------------------------------------------------------

    def _next_version(self, art_dir: Path) -> int:
        latest = self._latest_version(art_dir)
        return 0 if latest is None else latest + 1

    def _latest_version(self, art_dir: Path) -> int | None:
        versions = [
            int(p.name[1:]) for p in art_dir.iterdir()
            if p.is_dir() and p.name.startswith("v")
        ]
        return max(versions) if versions else None

    def _handle(self, name: str, version: int, vdir: Path) -> ArtifactHandle:
        meta = json.loads((vdir / ".metadata.json").read_text())
        return ArtifactHandle(
            name=name,
            version=version,
            dir=vdir,
            type=meta.get("type", "file"),
            metadata=meta.get("metadata", {}),
        )
