"""Environment-variable configuration of the service (the port's own copy
of vector_store_tpu/config.py, with the settings the port's entry point
reads: no multi-host or default-capacity settings).

The reference configures itself purely from env vars / `.env` via dotenvy
(reference: src/main.rs:17,23-37; README.md "Configuration").  Same model
here: env vars with defaults, plus an optional `.env` file loaded at startup.

Additional knobs read where they apply (all optional):
  VST_REQUEST_TIMEOUT_S   serving deadline for query requests, 504 on
                          expiry (api/routes.py; default 0 = off)
  VST_IVF_ROWS_PER_BUCKET IVF geometry target (cluster granularity)
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def load_dotenv(path: str = ".env") -> None:
    """Minimal .env loader (reference: dotenvy at src/main.rs:17).

    Existing environment variables win, matching dotenvy's default.
    """
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                key, _, value = line.partition("=")
                key, value = key.strip(), value.strip().strip("'\"")
                os.environ.setdefault(key, value)
    except FileNotFoundError:
        pass


@dataclass
class Config:
    """Service configuration (reference env surface: src/main.rs:23-37)."""

    # Bind address of the HTTP API (reference: SCYLLA_USEARCH_URI, default
    # 127.0.0.1:6080 at src/main.rs:23-31).
    http_addr: str = field(
        default_factory=lambda: os.environ.get("VST_TPU_URI", "127.0.0.1:6080")
    )
    # Query batching window in milliseconds for the batching frontend.
    batch_window_ms: float = field(
        default_factory=lambda: float(os.environ.get("VST_TPU_BATCH_WINDOW_MS", "2.0"))
    )
    # Maximum queries coalesced into one device step.
    max_batch: int = field(
        default_factory=lambda: int(os.environ.get("VST_TPU_MAX_BATCH", "256"))
    )
    # Log level (reference: tracing EnvFilter default "info", src/main.rs:18-21).
    log_level: str = field(
        default_factory=lambda: os.environ.get("VST_TPU_LOG", "INFO")
    )
    # Devices to shard indexes over: 1 = one device (default), 0 = every
    # visible card, N = the first N.  Backed by shard/ (ANN) and
    # text/sharded_bm25.py (text).
    n_devices: int = field(
        default_factory=lambda: int(os.environ.get("VST_TPU_N_DEVICES", "1"))
    )
