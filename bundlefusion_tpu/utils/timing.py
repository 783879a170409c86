"""Per-frame stage timing, mirroring the reference's TimingLog.

The reference records a ``FrameTiming`` struct per frame with per-stage times
(``TimingLog.h:10-21``: sift detection, sift matching, the three match
filters, misc, solve + iterations, sensor processing, re-integration,
reconstruction, visualization), kept in separate local/global vectors with
averaged printout and CSV export (``TimingLog.cpp: printAllTimings``).

Times are host wall-clock around ``jax.block_until_ready`` sync
points; async-dispatched stages therefore attribute to the stage that forced
the sync — same semantics as the reference's cudaEvent timers around stream
syncs.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class FrameTiming:
    frame: int = -1
    time_sift_detection: float = 0.0
    time_sift_matching: float = 0.0
    time_match_filter_key_point: float = 0.0
    time_match_filter_surface_area: float = 0.0
    time_match_filter_dense_verify: float = 0.0
    time_misc: float = 0.0
    time_solve: float = 0.0
    num_iters_solve: int = 0
    time_sensor_process: float = 0.0
    time_re_integrate: float = 0.0
    time_reconstruct: float = 0.0
    time_visualize: float = 0.0
    # fused-program stages (one dispatch per phase)
    time_frame_step: float = 0.0
    time_submap_step: float = 0.0


class TimingLog:
    """Collects per-frame stage timings; context-manager based."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.local_frames: List[FrameTiming] = []
        self.global_frames: List[FrameTiming] = []
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    def new_frame(self, frame_idx: int, is_local: bool = True) -> FrameTiming:
        ft = FrameTiming(frame=frame_idx)
        (self.local_frames if is_local else self.global_frames).append(ft)
        return ft

    class _Stage:
        def __init__(self, log: "TimingLog", ft: Optional[FrameTiming], attr: str):
            self.log, self.ft, self.attr = log, ft, attr

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            if self.ft is not None:
                setattr(self.ft, self.attr, getattr(self.ft, self.attr) + dt)
            self.log._totals[self.attr] += dt
            self.log._counts[self.attr] += 1
            return False

    def stage(self, attr: str, ft: Optional[FrameTiming] = None) -> "_Stage":
        return TimingLog._Stage(self, ft, attr)

    def add(self, attr: str, dt: float) -> None:
        """Record one sample directly (for stages whose name is only known
        after the fact, e.g. the TSDF replay's plain/rows split)."""
        self._totals[attr] += dt
        self._counts[attr] += 1

    def averages(self) -> Dict[str, float]:
        return {
            k: self._totals[k] / max(self._counts[k], 1) for k in sorted(self._totals)
        }

    def totals(self) -> Dict[str, float]:
        return dict(self._totals)

    def print_all_timings(self) -> str:
        lines = ["stage, total_s, count, mean_ms"]
        for k in sorted(self._totals):
            tot, cnt = self._totals[k], self._counts[k]
            lines.append(f"{k}, {tot:.4f}, {cnt}, {1000.0 * tot / max(cnt, 1):.3f}")
        out = "\n".join(lines)
        print(out)
        return out

    def to_csv(self, path: str, which: str = "local") -> None:
        frames = self.local_frames if which == "local" else self.global_frames
        cols = [f.name for f in FrameTiming.__dataclass_fields__.values()]  # type: ignore[attr-defined]
        cols = list(FrameTiming.__dataclass_fields__.keys())
        with open(path, "w") as fh:
            fh.write(",".join(cols) + "\n")
            for ft in frames:
                fh.write(",".join(str(getattr(ft, c)) for c in cols) + "\n")
