"""Lock-discipline violations (L001/L002/L003) in a threaded class."""
import threading

import torch


class BadPipeline:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending = []
        self._count = 0
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, item):
        self._pending.append(item)  # L001: shared write, no lock
        self._count += 1            # L001
        with self._cv:
            self._cv.notify_all()

    def wait_idle(self):
        self._cv.wait()             # L002: wait without the lock

    def _loop(self):
        while True:
            with self._lock:
                if self._pending:
                    ex, event = self._pending.pop()
                    self._count -= 1
                    ex.run()                    # L003: blocking under lock
                    event.synchronize()         # L003
                    torch.cuda.synchronize()    # L003
