"""Mean wall time of a ``synthesize`` / ``synthesize_batch`` call in ms
(host clock; the call ends in host copies of its outputs)."""


def read(rec):
    calls = rec.get("calls", [])
    return 1e3 * sum(c["t1"] - c["t0"] for c in calls) / len(calls) if calls else None
