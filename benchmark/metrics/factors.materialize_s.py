"""factors.materialize_s: seconds per call to read the factors to the
host (fact.U, and fact.L where the mix reads it, then a device
synchronize), by the benchmark's own clock around that read."""


def read(rec):
    clock = rec["clocks"].get("read") or []
    return sum(clock) / len(clock) if clock else None
