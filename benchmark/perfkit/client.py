"""The open-loop HTTP client of the serve mixes, run in a process of its own
so that its work never takes the server's interpreter lock.  Standard
library only.

It takes jobs over a pipe: ("send", host, port, [(due, body)], t0,
timeout) posts each body to /search at t0 + due (time.monotonic, which is
one clock for every process of the host), whether or not earlier ones have
been answered, and replies [(due, sent, done, status, body)]; "stop" ends
it.  `done` is None for a request that got no answer within `timeout`
seconds of the last due time.
"""

import asyncio
import time

_HEAD = ("POST /search HTTP/1.1\r\nHost: localhost\r\n"
         "Content-Type: application/json\r\nContent-Length: {n}\r\n"
         "Connection: close\r\n\r\n")


async def _post(host, port, body: bytes):
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(_HEAD.format(n=len(body)).encode() + body)
        await writer.drain()
        data = await reader.read()
    finally:
        writer.close()
    head, _, payload = data.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1]) if head else 0
    return status, payload


async def _one(host, port, t0, due, body, out, i):
    await asyncio.sleep(max(0.0, t0 + due - time.monotonic()))
    sent = time.monotonic()
    try:
        status, payload = await _post(host, port, body)
        out[i] = (due, sent, time.monotonic(), status, payload)
    except OSError as e:
        out[i] = (due, sent, None, -1, repr(e).encode())


async def _send(host, port, jobs, t0, timeout):
    out = [None] * len(jobs)
    tasks = [asyncio.ensure_future(_one(host, port, t0, due, body, out, i))
             for i, (due, body) in enumerate(jobs)]
    last = max((due for due, _ in jobs), default=0.0)
    limit = max(0.0, t0 + last + timeout - time.monotonic())
    if tasks:
        _, pending = await asyncio.wait(tasks, timeout=limit)
        for t in pending:
            t.cancel()
        await asyncio.gather(*pending, return_exceptions=True)
    return [r if r is not None else (due, None, None, -1, b"no answer")
            for r, (due, _) in zip(out, jobs)]


def client_main(conn):
    """The process's entry: serve jobs from `conn` until "stop"."""
    while True:
        job = conn.recv()
        if job[0] == "stop":
            conn.close()
            return
        _, host, port, jobs, t0, timeout = job
        conn.send(asyncio.run(_send(host, port, jobs, t0, timeout)))
