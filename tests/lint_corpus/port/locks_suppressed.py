"""Lock-discipline findings suppressed inline, each with its reason."""
import threading


class Pipeline:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending = []
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, item):
        # one producer thread, ordered by the start barrier
        self._pending.append(item)  # repro: allow[L001]

    def poll(self):
        # a timed poll whose caller holds the lock
        self._cv.wait(0.01)  # repro: allow[L002]

    def _loop(self):
        with self._lock:
            self._pending.clear()
            # the run must finish before the queue is read again
            self._pending and self._pending[0].run()  # repro: allow[L003]
