"""Error types for searchlite-tpu.

The reference engine surfaces most failures as `anyhow::Error` strings;
we use a small exception hierarchy so surfaces (CLI/HTTP) can map them
to exit codes / HTTP statuses.
"""


class SearchliteError(Exception):
    """Base class for all searchlite-tpu errors."""


class SchemaError(SearchliteError):
    """Invalid schema definition or document that violates the schema."""


class QueryError(SearchliteError):
    """Invalid query, filter, aggregation, or request parameter."""


class StorageError(SearchliteError):
    """I/O failures, checksum mismatches, corrupt or missing files."""


class CursorError(QueryError):
    """Invalid, stale, or tampered pagination cursor."""
