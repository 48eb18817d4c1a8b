"""Lock discipline kept: shared writes under the lock, waits with it
held, blocking calls outside it."""
import threading


class GoodPipeline:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending = []
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, item):
        with self._cv:
            self._pending.append(item)
            self._cv.notify_all()

    def wait_idle(self):
        with self._cv:
            self._cv.wait()

    def _loop(self):
        while True:
            with self._lock:
                work = self._pending.pop() if self._pending else None
            if work is not None:
                ex, event = work
                ex.run()
                event.synchronize()
