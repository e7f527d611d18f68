"""Flight recorder: a deterministic fixed-size ring of per-step frames.

Every run loop (trainer step, router step) records one *frame* per step:
the step index plus a small dict of sampled quantities — step wall time,
tokens emitted, DP size, queue depth, free KV pages, the tracer's
accumulated span wall.  The ring keeps the last ``capacity`` frames; when
an incident opens, :mod:`repro_torch.obs.incidents` copies the pre/post window
around the opening step out of the ring into the incident record, like a
crashed aircraft's last N seconds of instruments.

Determinism contract: the ring is a pure function of the ``record()``
calls — no clocks, no sampling jitter.  Frame *fields* split into two
classes (see docs/observability.md):

* **pinned** — derived from replay-pinned quantities (step index, token
  counts, dp_size, queue depth, free pages).  These replay bit-exactly
  and may appear in golden incident logs.
* **unpinned** — wall-clock quantities (``wall_s``, ``span_s``).  They
  ride along in the JSONL for humans and the cost model but are dropped
  from the pinned projection a golden log is verified against.

The recorder is a pure side channel: it only ever *reads* run state.

The port's copy of ``repro.obs.flight``: the same code, with its imports renamed
to ``repro_torch``.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional

# frame fields that are NOT derived from replay-pinned quantities; the
# pinned projection (and therefore golden incident logs) drops these
UNPINNED_FRAME_FIELDS = ("wall_s", "span_s", "snap_blocked_s")

DEFAULT_CAPACITY = 64
DEFAULT_WINDOW = 8


class FlightRecorder:
    """Fixed-capacity ring buffer of per-step telemetry frames."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 window: int = DEFAULT_WINDOW) -> None:
        if capacity < 2 * window:
            raise ValueError(
                f"capacity {capacity} cannot cover a +/-{window}-step window"
            )
        self.capacity = int(capacity)
        self.window = int(window)
        self._frames: Deque[Dict] = deque(maxlen=self.capacity)
        self.n_recorded = 0

    def record(self, step: int, **fields) -> Dict:
        """Append one frame; ``None``-valued fields are dropped."""
        frame = {"step": int(step)}
        frame.update(
            {k: v for k, v in fields.items() if v is not None}
        )
        self._frames.append(frame)
        self.n_recorded += 1
        return frame

    def frames(self) -> List[Dict]:
        return [dict(f) for f in self._frames]

    def frames_between(self, lo: int, hi: int) -> List[Dict]:
        """Frames with ``lo <= step <= hi`` still held by the ring."""
        return [dict(f) for f in self._frames if lo <= f["step"] <= hi]

    def window_around(self, step: int) -> List[Dict]:
        """The pre/post window: frames in ``[step - W, step + W]``."""
        return self.frames_between(step - self.window, step + self.window)

    def last(self, n: int) -> List[Dict]:
        """The most recent ``n`` frames (fewer if the ring is young)."""
        if n <= 0:
            return []
        return [dict(f) for f in list(self._frames)[-n:]]

    def __len__(self) -> int:
        return len(self._frames)


def pinned_frame(frame: Dict) -> Dict:
    """The replay-pinned projection of one frame (drops wall-clock fields)."""
    return {k: v for k, v in frame.items() if k not in UNPINNED_FRAME_FIELDS}
