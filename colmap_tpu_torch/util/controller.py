"""Controller base: run-state callbacks + Stop/Pause/Resume injection.

Copy of colmap_tpu/util/controller.py (reference: util/base_controller.h:42
and util/threading.h:97). The pipelines are host loops around batched
device calls, so control is cooperative: long-running loops call
`check_if_stopped()` between rounds — a paused controller blocks there
until resumed, a stopped one unwinds gracefully (pipelines return the
best model built so far).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List

STARTED_CALLBACK = "STARTED"
FINISHED_CALLBACK = "FINISHED"


class BaseController:
    def __init__(self):
        self._callbacks: Dict[str, List[Callable[[], None]]] = {}
        self._stop_event = threading.Event()
        self._resume_event = threading.Event()
        self._resume_event.set()  # not paused
        self.register_callback(STARTED_CALLBACK)
        self.register_callback(FINISHED_CALLBACK)

    # -- callbacks (reference: AddCallback/Callback) -----------------------
    def register_callback(self, name: str):
        self._callbacks.setdefault(name, [])

    def add_callback(self, name: str, fn: Callable[[], None]):
        self._callbacks.setdefault(name, []).append(fn)

    def callback(self, name: str):
        for fn in self._callbacks.get(name, []):
            fn()

    # -- stop/pause (reference: Thread::Stop/Pause/Resume/IsStopped) -------
    def request_stop(self):
        self._stop_event.set()
        self._resume_event.set()  # a paused controller must unwind too

    def request_pause(self):
        if not self._stop_event.is_set():
            self._resume_event.clear()

    def resume(self):
        self._resume_event.set()

    def is_stopped(self) -> bool:
        return self._stop_event.is_set()

    def is_paused(self) -> bool:
        return not self._resume_event.is_set()

    def check_if_stopped(self) -> bool:
        """Block while paused; return True when a stop was requested.

        The analog of the reference's BlockIfPaused() + IsStopped() pair
        that controllers call inside their run loops."""
        self._resume_event.wait()
        return self._stop_event.is_set()

    def reset_control(self):
        self._stop_event.clear()
        self._resume_event.set()
