"""The closed loop: one client submits a scan, waits for its volume, and
submits the next as soon as it lands; the pool's scans in turn. A scan is
due when it is submitted."""
import time

from bench.harness.client import Scan


def drive(client, mix, t_start, seconds, seed):
    scans = []
    t_end = t_start + seconds
    while True:
        now = time.perf_counter() if scans else t_start
        if now >= t_end:
            return scans
        scan = Scan(due=now, pool=len(scans) % int(mix["pool"]))
        client.submit(scan)
        client.receive(scan)
        scans.append(scan)
