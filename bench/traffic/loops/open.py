"""The open loop: scans arrive at the mix's `rate_per_s` whatever the
service does (bench/harness/traffic.py's seeded Poisson schedule), each
pool scan equally often. A generator thread submits each at its arrival;
a receiver thread waits for the volumes in order. A scan is due at its
scheduled arrival, so a late generator counts against the service."""
import queue
import threading
import time

from bench.harness import traffic
from bench.harness.client import Scan


def drive(client, mix, t_start, seconds, seed):
    offsets = traffic.open_arrivals(float(mix["rate_per_s"]), seconds, seed)
    order = traffic.pool_order(len(offsets), int(mix["pool"]), seed)
    sent = queue.Queue()
    scans = []

    def generate():
        for off, p in zip(offsets, order):
            scan = Scan(due=t_start + float(off), pool=p)
            delay = scan.due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            scan.late = time.perf_counter() - scan.due
            client.submit(scan)
            sent.put(scan)
        sent.put(None)

    def receive():
        while (scan := sent.get()) is not None:
            client.receive(scan)
            scans.append(scan)

    threads = [threading.Thread(target=generate, name="bench-generate"),
               threading.Thread(target=receive, name="bench-receive")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return scans
