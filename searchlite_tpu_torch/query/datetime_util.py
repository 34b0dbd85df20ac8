"""Date helpers for date_range / date_histogram aggregations.

Parity targets the reference's chrono usage (`query/aggs/mod.rs:3380-
3474`): values are RFC3339 strings or epoch milliseconds; calendar
intervals day/week/month/quarter/year and fixed intervals like "30m",
"1h", "7d"; bucket keys are epoch milliseconds formatted back to
RFC3339 (or a custom strftime-ish format).
"""

from __future__ import annotations

from datetime import datetime, timedelta, timezone

from searchlite_tpu_torch.errors import QueryError

_UNITS_MS = {
    "ms": 1,
    "s": 1000,
    "m": 60_000,
    "h": 3_600_000,
    "d": 86_400_000,
}


def parse_datetime_millis(value) -> int:
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return int(value)
    if isinstance(value, str):
        raw = value.strip()
        if raw.isdigit() or (raw.startswith("-") and raw[1:].isdigit()):
            return int(raw)
        try:
            if raw.endswith("Z"):
                raw = raw[:-1] + "+00:00"
            dt = datetime.fromisoformat(raw)
        except ValueError as e:
            raise QueryError(f"invalid datetime `{value}`") from e
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        return int(dt.timestamp() * 1000)
    raise QueryError(f"invalid datetime `{value}`")


def parse_duration_millis(value: str) -> int:
    raw = value.strip()
    for unit in ("ms", "s", "m", "h", "d"):
        if raw.endswith(unit):
            num = raw[: -len(unit)]
            try:
                return int(float(num) * _UNITS_MS[unit])
            except ValueError as e:
                raise QueryError(f"invalid duration `{value}`") from e
    raise QueryError(f"invalid duration `{value}`")


def calendar_bucket(millis: int, interval: str) -> int:
    dt = datetime.fromtimestamp(millis / 1000.0, tz=timezone.utc)
    name = interval.strip().lower()
    if name in ("day", "1d"):
        start = dt.replace(hour=0, minute=0, second=0, microsecond=0)
    elif name in ("week", "1w"):
        day_start = dt.replace(hour=0, minute=0, second=0, microsecond=0)
        start = day_start - timedelta(days=day_start.weekday())
    elif name in ("month", "1m"):
        start = dt.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    elif name in ("quarter", "1q"):
        month = ((dt.month - 1) // 3) * 3 + 1
        start = dt.replace(month=month, day=1, hour=0, minute=0, second=0,
                           microsecond=0)
    elif name in ("year", "1y"):
        start = dt.replace(month=1, day=1, hour=0, minute=0, second=0,
                           microsecond=0)
    else:
        raise QueryError(f"unknown calendar interval `{interval}`")
    return int(start.timestamp() * 1000)


def calendar_bucket_vec(millis, interval: str):
    """Vectorized ``calendar_bucket`` over an int64 millis array.

    Same UTC floor semantics as the scalar version (equivalence is
    property-tested in tests/test_aggs_bounded.py): day/week by integer
    arithmetic, month/quarter/year via numpy datetime64 truncation
    (which floors toward -inf, matching datetime.replace)."""
    import numpy as np

    d = np.asarray(millis, dtype=np.int64)
    name = interval.strip().lower()
    day_ms = 86_400_000
    if name in ("day", "1d"):
        return (d // day_ms) * day_ms
    if name in ("week", "1w"):
        days = d // day_ms
        # 1970-01-01 was a Thursday (weekday 3, Monday=0)
        start = days - (days + 3) % 7
        return start * day_ms
    months = d.astype("datetime64[ms]").astype("datetime64[M]")
    if name in ("month", "1m"):
        key = months
    elif name in ("quarter", "1q"):
        m = months.astype(np.int64)
        key = ((np.floor_divide(m, 3)) * 3).astype("datetime64[M]")
    elif name in ("year", "1y"):
        key = d.astype("datetime64[ms]").astype("datetime64[Y]")
    else:
        raise QueryError(f"unknown calendar interval `{interval}`")
    return key.astype("datetime64[ms]").astype(np.int64)


def next_calendar_bucket(millis: int, interval: str) -> int:
    """Start of the calendar bucket after the one at `millis` (parity:
    aggs/mod.rs add_interval — used to densify empty buckets across
    extended/hard bounds)."""
    dt = datetime.fromtimestamp(millis / 1000.0, tz=timezone.utc)
    name = interval.strip().lower()
    if name in ("day", "1d"):
        nxt = dt + timedelta(days=1)
    elif name in ("week", "1w"):
        nxt = dt + timedelta(weeks=1)
    elif name in ("month", "1m"):
        if dt.month == 12:
            nxt = dt.replace(year=dt.year + 1, month=1)
        else:
            nxt = dt.replace(month=dt.month + 1)
    elif name in ("quarter", "1q"):
        month = dt.month + 3
        nxt = dt.replace(year=dt.year + (month - 1) // 12,
                         month=(month - 1) % 12 + 1)
    elif name in ("year", "1y"):
        nxt = dt.replace(year=dt.year + 1)
    else:
        raise QueryError(f"unknown calendar interval `{interval}`")
    return int(nxt.timestamp() * 1000)


def format_millis(millis: int, fmt: str | None = None) -> str:
    dt = datetime.fromtimestamp(millis / 1000.0, tz=timezone.utc)
    if fmt is None or fmt in ("strict_date_time", "rfc3339"):
        return dt.isoformat().replace("+00:00", "Z")
    if fmt == "strict_date":
        return dt.strftime("%Y-%m-%d")
    if fmt == "epoch_millis":
        return str(millis)
    return dt.strftime(fmt)
