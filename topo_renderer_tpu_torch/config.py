"""Runtime configuration: ``Settings.toml`` + ``TOPO_*`` environment overrides.

Copy of the JAX package's `config.py` for the PyTorch port.

The reference loads the same keys (``data_dir``, ``backend_url``, ``address``,
``port``) via the Rust `config` crate with a ``TOPO_`` env prefix —
at compile time for the renderer (`topo-renderer/build.rs:4-14`, read back at
`topo-renderer/src/app.rs:58-60`) and at runtime for the backend
(`topo-backend/src/main.rs:104-110`). Per SURVEY §5 we deliberately make both
runtime-configurable instead of copying the compile-time bake.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from pathlib import Path
from typing import Any


@dataclasses.dataclass
class Settings:
    """Application settings shared by renderer and backend.

    Defaults mirror the reference: backend listens on ``0.0.0.0:3333``
    (`topo-backend/src/main.rs:107-108`).
    """

    backend_url: str = "http://localhost:3333"
    data_dir: str = "data"
    address: str = "0.0.0.0"
    port: int = 3333
    # No reference analog: row-shard the big terrain tables across the
    # first N local devices. 0/1 = one device. The port refuses N > 1 until
    # its multi-device slice (`app/application.py`).
    geo_shard: int = 0
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    @staticmethod
    def load(path: str | Path | None = None, env: dict[str, str] | None = None) -> "Settings":
        """Load ``Settings.toml`` (if present) then apply ``TOPO_*`` env overrides.

        Resolution order (highest wins): env > file > defaults, matching the
        `config` crate's source stacking in `topo-backend/src/main.rs:104-110`.
        """
        values: dict[str, Any] = {}
        candidates = [Path(path)] if path is not None else [
            Path("Settings.toml"),
            Path(os.environ.get("TOPO_SETTINGS", "")) if os.environ.get("TOPO_SETTINGS") else None,
        ]
        for cand in candidates:
            if cand is not None and cand.is_file():
                with open(cand, "rb") as f:
                    values.update(tomllib.load(f))
                break

        env = dict(os.environ if env is None else env)
        for key, val in env.items():
            if key.startswith("TOPO_") and key != "TOPO_SETTINGS":
                values[key[len("TOPO_"):].lower()] = val

        known = {f.name for f in dataclasses.fields(Settings)} - {"extra"}
        kwargs = {k: v for k, v in values.items() if k in known}
        if "port" in kwargs:
            kwargs["port"] = int(kwargs["port"])
        if "geo_shard" in kwargs:
            kwargs["geo_shard"] = int(kwargs["geo_shard"])
        extra = {k: v for k, v in values.items() if k not in known}
        return Settings(**kwargs, extra=extra)
