"""Mean host time of a request's embed (``service.embed``, which ends in a
copy to the host), its wait for the lock taken out, per request, in ms."""


def read(name, r):
    if r.get("kind") != "search" or r.get("spans") is None or not r.get("served"):
        return None
    return r["embed_self_s"] * 1e3 / r["served"]
