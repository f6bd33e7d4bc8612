"""Requests a device call served over the window: the service's own
counters (``TTSService.n_requests`` / ``n_device_calls``), read at the
window's start and after its last answer."""


def read(rec):
    c = rec.get("counters") or {}
    if not c.get("device_calls"):
        return None
    return c["requests"] / c["device_calls"]
