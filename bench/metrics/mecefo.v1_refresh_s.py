"""mecefo.v1_refresh_s (s): the host duration of the program's
``mecefo.v1_refresh`` span (``refresh_projections``, whose SVDs synchronise)
at the root of the span tree: the set-up's one V1 refresh, from the
tracer's aggregate of that path.  Nothing to read where the cell's program
refreshes no V1 (the healthy program, which keeps zero projections:
``bench/program.py``) or keeps no such span.  Moves ``setup_s``."""
from stepspans import tracer


def read(run):
    tr = tracer()
    agg = tr.aggregates.get("mecefo.v1_refresh") if tr is not None else None
    return float(agg[1]) if agg else None
