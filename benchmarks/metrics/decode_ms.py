"""Mean host time of a request's upload decode (``service.decode_batch``:
the entropy decode and J1, to the pixels on the host), per request, in ms."""


def read(name, r):
    if r.get("kind") != "search" or r.get("spans") is None or not r.get("served"):
        return None
    return r["spans"].total_s("decode") * 1e3 / r["served"]
