"""Mean time from a request's due time to the start of the synthesizer
call that served it, in ms; a request is matched to its call by its seed,
which is distinct in every request."""


def read(rec):
    start = {}
    for c in rec.get("calls", []):
        for s in c["seeds"]:
            start.setdefault(s, c["t0"])
    waits = [start[r["seed"]] - r["due"] for r in rec.get("requests", []) if r["seed"] in start]
    return 1e3 * sum(waits) / len(waits) if waits else None
