"""The search cells' load generator, a process of its own (standard library
only, so that it starts fast and shares no interpreter with the server).

It reads one JSON line on stdin: ``port``, ``uploads`` (the directory of
JPEGs), ``names`` (the file of each image id), ``seconds`` and either
``schedule`` (open loop: ``[due_s, [image ids], k]`` per request, sent at
its due time whatever came back before it) or ``clients`` (closed loop:
each client's list of ``[[image ids], k]``, sent one after another, the
next when the reply came). It prints ``READY``, waits for a ``GO`` line,
takes that moment as the window's start, and at the end prints one JSON
line: the start on the wall clock, and each request's ``[due, sent, done,
status, indices, distances]`` in seconds from the start (due = sent in a
closed loop; a request that got no reply has done = null). A request that
is still out ``grace_s`` seconds after the window's close is given up."""

from __future__ import annotations

import base64
import http.client
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor


def post(port: int, body: bytes, timeout: float):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/search", body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def main() -> None:
    spec = json.loads(sys.stdin.readline())
    b64 = {}
    for i, name in enumerate(spec["names"]):
        with open(os.path.join(spec["uploads"], name), "rb") as f:
            b64[i] = base64.b64encode(f.read()).decode()

    def body(ids, k) -> bytes:
        return json.dumps({"images_b64": [b64[i] for i in ids], "k": k}).encode()

    seconds, grace = float(spec["seconds"]), float(spec.get("grace_s", 60.0))
    port = int(spec["port"])
    results = []
    lock = threading.Lock()
    print("READY", flush=True)
    if sys.stdin.readline().strip() != "GO":
        return
    t0_wall, t0 = time.time(), time.perf_counter()

    def one(due: float, ids, k, timeout: float):
        sent = time.perf_counter() - t0
        try:
            status, payload = post(port, body(ids, k), timeout)
            done = time.perf_counter() - t0
            out = json.loads(payload) if status == 200 else {}
            row = [due, sent, done, status, out.get("indices"), out.get("distances"), ids]
        except (OSError, http.client.HTTPException, ValueError) as e:
            row = [due, sent, None, repr(e), None, None, ids]
        with lock:
            results.append(row)

    if "schedule" in spec:  # open loop
        schedule = spec["schedule"]
        with ThreadPoolExecutor(max_workers=int(spec.get("max_in_flight", 256))) as pool:
            futures = []
            for i, (due, ids, k) in enumerate(schedule):
                wait = t0 + due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                budget = seconds + grace - (time.perf_counter() - t0)
                futures.append(pool.submit(one, due, ids, k, max(budget, 1.0)))
            for f in futures:
                f.result()
    else:  # closed loop
        def client(requests):
            for ids, k in requests:
                now = time.perf_counter() - t0
                if now >= seconds:
                    return
                one(now, ids, k, max(seconds + grace - now, 1.0))

        threads = [threading.Thread(target=client, args=(reqs,)) for reqs in spec["clients"]]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    results.sort(key=lambda r: (r[0], r[1]))
    sys.stdout.write(json.dumps({"t0_wall": t0_wall, "results": results}) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
