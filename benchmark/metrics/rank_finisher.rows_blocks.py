"""rank_finisher.rows_blocks: the program's `spasm/rref_rows` ranges per
call (ranges of one thread merged first, so a nested entry counts once):
the blocks the rank finisher swept, which in rows mode ends at the early
abort on the rows not yet consumed."""
from benchmark import spans


def read(rec):
    found = spans.host_spans(rec, "spasm/rref_rows")
    if not found or not rec["ncalls"]:
        return None
    return sum(len(v) for v in found.values()) / rec["ncalls"]
