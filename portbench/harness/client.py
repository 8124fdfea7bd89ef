"""The open-loop HTTP client of the serving cells, run in a child process
of the benchmark so that its work does not take the server's interpreter
lock:

    python -m portbench.harness.client HOST PORT SCHEDULE.json OUT.json

It reads the schedule (``[[due offset in s, [SMILES...]], ...]``), waits
for one line on standard input holding the window's start (a
``time.monotonic()`` reading, which the parent shares), sends each request
at its due time whatever the replies before it, and writes for each
request ``[send lateness s, latency s (from the due time), HTTP status,
predictions or null]``.  A request that fails gets status 0 and latency
null.  It imports nothing of the program and no torch.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time


async def _one(host, port, due, body, timeout):
    now = time.monotonic()
    if due > now:
        await asyncio.sleep(due - now)
    late = time.monotonic() - due
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout)
        writer.write(
            (f"POST /predict HTTP/1.1\r\nHost: {host}\r\n"
             "Content-Type: application/json\r\n"
             f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
             ).encode() + body)
        await writer.drain()
        data = await asyncio.wait_for(reader.read(), timeout)
        done = time.monotonic()
        writer.close()
        head, _, payload = data.partition(b"\r\n\r\n")
        status = int(head.split(b" ", 2)[1])
        preds = json.loads(payload)["predictions"] if status == 200 else None
        return [late, done - due, status, preds]
    except (OSError, ValueError, IndexError, KeyError,
            asyncio.TimeoutError):
        return [late, None, 0, None]


async def _main(host, port, schedule, start, timeout):
    tasks = [asyncio.create_task(_one(
        host, port, start + t, json.dumps({"smiles": s}).encode(), timeout))
        for t, s in schedule]
    return await asyncio.gather(*tasks)


def main(argv=None) -> int:
    host, port, sched_path, out_path, timeout = (argv or sys.argv[1:])[:5]
    with open(sched_path) as f:
        schedule = json.load(f)
    print("ready", flush=True)
    start = float(sys.stdin.readline())
    results = asyncio.run(_main(host, int(port), schedule, start,
                                float(timeout)))
    with open(out_path, "w") as f:
        json.dump(results, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
