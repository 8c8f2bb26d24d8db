"""Ingestion pipeline: sources, fake DB, monitors (SURVEY §7.3)."""

from .memdb import MemDb  # noqa: F401
from .monitor_indexes import MonitorIndexes  # noqa: F401
from .source import DbSource, EmbeddingStream  # noqa: F401
from . import monitor_items  # noqa: F401
