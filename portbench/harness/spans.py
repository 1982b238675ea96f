"""The program's spans (``lisec_tpu_torch.utils.profiling``) as the
per-layer readers take them.

The program records spans only while a profiler records, which in a run
is the traced window alone, so the record read after the window holds
the traced requests. A program without spans gives every reader
nothing.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional


def record() -> Optional[List[Dict]]:
    """The program's span record, or None where it keeps none."""
    try:
        from lisec_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    return spans()


def host_ms(s: Dict) -> float:
    return (s["end_ns"] - s["start_ns"]) * 1e-6


def stream_ms(s: Dict) -> float:
    return s["stream_ms"]


def count(s: Dict) -> float:
    return 1.0


def per_request(names: Iterable[str], value: Callable[[Dict], float],
                per: str = "infer") -> Optional[float]:
    """``value`` summed over the spans named in ``names``, over the
    number of spans named ``per`` (one a request); None where the record
    holds neither."""
    rec = record()
    if not rec:
        return None
    names = set(names)
    n = sum(s["name"] == per for s in rec)
    hits = [value(s) for s in rec if s["name"] in names]
    if not n or not hits:
        return None
    return sum(hits) / n
