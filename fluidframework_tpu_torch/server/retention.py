"""The summary store's GC pins: the retention plane's in-flight-write
guard.

Copied from fluidframework_tpu/server/retention.py: `PIN_TTL_S`
(:135), `_pins_dir` (:143), `write_pin` (:147), `clear_pin` (:166) and
`live_pin_floor` (:173). The summarizer pins the store around each
emission round (`summarizer.SummarizerRole.flush_batch`); the sweep
that honours the pins (`RetentionRole`, the castore GC and the fenced
op-log truncation) is ROADMAP.md Queue 1 item 4. Pin files are the
reference's (``<shared>/store/pins/<name>.json``, ``{"t", "name"}``),
so a sweep of either package sees the other's pins.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

__all__ = ["PIN_TTL_S", "clear_pin", "live_pin_floor", "write_pin"]

# A pin whose FILE has not been rewritten for this long is ignored:
# the writer died, and recovery re-puts its blobs before
# re-referencing them. Liveness is the file mtime: a live writer
# heartbeats mid-round by rewriting the pin with its ORIGINAL floor
# (`write_pin(..., t=)`), so a round longer than the TTL keeps its
# early puts covered.
PIN_TTL_S = 60.0


def _pins_dir(shared_dir: str) -> str:
    return os.path.join(shared_dir, "store", "pins")


def write_pin(shared_dir: str, name: str,
              t: Optional[float] = None) -> float:
    """Pin the summary store: blobs put from now on must survive the
    sweep until the pin clears (the manifest referencing them is not
    durable yet). One pin file per writer identity. Returns the floor
    timestamp; a writer mid-round heartbeats by calling again with
    that SAME `t`: the rewrite advances the file mtime (liveness)
    while keeping the floor, so blobs put earlier in a long round
    stay covered past PIN_TTL_S."""
    t = time.time() if t is None else t
    d = _pins_dir(shared_dir)
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{name}.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump({"t": t, "name": name}, f)
    os.replace(tmp, os.path.join(d, f"{name}.json"))
    return t


def clear_pin(shared_dir: str, name: str) -> None:
    try:
        os.unlink(os.path.join(_pins_dir(shared_dir), f"{name}.json"))
    except OSError:
        pass


def live_pin_floor(shared_dir: str,
                   now: Optional[float] = None) -> Optional[float]:
    """The oldest LIVE pin timestamp (None: no live pins). The sweep
    must not delete any blob whose mtime is at/after this instant: it
    may be referenced by a manifest still in flight."""
    now = time.time() if now is None else now
    floor: Optional[float] = None
    try:
        names = os.listdir(_pins_dir(shared_dir))
    except OSError:
        return None
    for fn in names:
        if not fn.endswith(".json"):
            continue
        path = os.path.join(_pins_dir(shared_dir), fn)
        try:
            mtime = os.stat(path).st_mtime
            with open(path) as f:
                t = float(json.load(f).get("t", 0.0))
        except (OSError, ValueError, TypeError):
            continue
        if now - mtime > PIN_TTL_S:
            continue  # stale heartbeat: the writer died; recovery re-puts
        floor = t if floor is None else min(floor, t)
    return floor
