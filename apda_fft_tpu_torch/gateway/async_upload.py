"""Background uploads: the capability the reference stubbed but never built.

``Gateway._background_upload_task`` (``GT_FFT_v5.py:109-113``) is an empty
method whose docstring promises "runs in parallel, 120 second timeout,
without blocking radio reception".  This module implements it: egress flushes
run on a worker thread while the receive loop keeps draining packets; results
are applied back to the upload queues from the main thread (no shared-state
races - the queues are only touched by the gateway thread), and jobs that
exceed the timeout are abandoned (their late results ignored), so a hung FTP
server can never stall acquisition.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from dataclasses import dataclass
from typing import Callable


@dataclass
class _Job:
    future: concurrent.futures.Future
    on_done: Callable[[object], None]
    deadline: float
    label: str = ""


class AsyncUploadManager:
    """Thread-pool egress with main-thread result application.

    ``submit`` schedules ``fn()`` on a worker; ``poll`` (called from the
    gateway loop) applies completed results via ``on_done`` and abandons jobs
    past their deadline.  Timed-out jobs simply never prune their queues, so
    the affected files retry at the sensor's next sync - the same recovery
    contract as the synchronous path.
    """

    def __init__(self, timeout: float = 120.0, max_workers: int = 2):
        self.timeout = timeout
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="apda-upload"
        )
        self._jobs: list[_Job] = []
        self._lock = threading.Lock()

    def submit(self, fn: Callable[[], object], on_done: Callable[[object], None],
               label: str = "") -> None:
        job = _Job(self._pool.submit(fn), on_done, time.monotonic() + self.timeout, label)
        with self._lock:
            self._jobs.append(job)

    def poll(self, log=None) -> int:
        """Apply finished jobs; drop expired ones.  Returns jobs applied."""
        applied = 0
        now = time.monotonic()
        done: list[tuple[_Job, object]] = []
        with self._lock:
            jobs, self._jobs = self._jobs, []
            keep: list[_Job] = []
            for job in jobs:
                if job.future.done():
                    try:
                        result = job.future.result()
                    except Exception as exc:  # noqa: BLE001 - sink already logged
                        if log:
                            log(f"\t[ASYNC][ERROR] {job.label}: {exc}\n")
                        # Failure still completes the job: on_done with an
                        # empty result prunes nothing but releases the
                        # caller's in-flight accounting.
                        done.append((job, []))
                        continue
                    done.append((job, result))
                    applied += 1
                elif now > job.deadline:
                    # Drop never-started queued jobs so hung workers don't
                    # also starve the queue; running jobs can't be interrupted
                    # but their late results are ignored.
                    job.future.cancel()
                    if log:
                        log(f"\t[ASYNC][WARN] upload {job.label} exceeded "
                            f"{self.timeout:.0f}s, abandoned (will retry at next sync)\n")
                    # Same: release accounting; a late success is ignored (the
                    # files stay queued and retry - worst case a duplicate
                    # upload, never a lost one).
                    done.append((job, []))
                else:
                    keep.append(job)
            self._jobs.extend(keep)
        # Callbacks run outside the lock (they may submit new jobs) and are
        # individually shielded so one failure cannot strand the others'
        # in-flight accounting.
        for job, result in done:
            try:
                job.on_done(result)
            except Exception as exc:  # noqa: BLE001
                if log:
                    log(f"\t[ASYNC][ERROR] on_done for {job.label}: {exc}\n")
        return applied

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._jobs)

    def drain(self, timeout: float = 10.0, log=None) -> None:
        """Block until all jobs finish or ``timeout`` elapses (for shutdown/tests)."""
        end = time.monotonic() + timeout
        while self.pending and time.monotonic() < end:
            self.poll(log)
            time.sleep(0.01)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
