"""Mean time a request waited for the service's lock (``DescriptorService._lock``,
swapped for a lock that times its waits), per request served, in ms."""


def read(name, r):
    if r.get("kind") != "search" or r.get("spans") is None or not r.get("served"):
        return None
    return r["spans"].total_s("lock_wait") * 1e3 / r["served"]
