"""Mean host time of a request's HTTP work: the program's ``serve.read``
(the body, its JSON parse and base64 decode) and ``serve.respond`` (the
answer's lists, JSON and write) spans in the traced window, per request
served (``serve.requests``), in ms."""

from benchmarks.metrics._spans import window_events


def read(name, r):
    ev = window_events(r) if r.get("kind") == "search" else None
    served = ev.count("serve.requests") if ev is not None else 0
    if not served:
        return None
    return ev.total_s(("serve.read", "serve.respond")) * 1e3 / served
