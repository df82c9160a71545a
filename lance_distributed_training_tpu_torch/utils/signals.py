"""SIGTERM → graceful stop of the trainer.

Counterpart of :class:`PreemptionHandler` in
``lance_distributed_training_tpu/utils/signals.py``. ``docker stop`` and
Kubernetes preemption deliver SIGTERM: the handler only sets a flag that the
step loop polls at step boundaries, so the in-flight step finishes, an
emergency checkpoint is taken (awaited) and ``train()`` returns normally.
The previous signal disposition is restored on :meth:`uninstall` (a
``train()`` inside pytest or a notebook must not keep SIGTERM). The JAX
handler also counts ``trainer_preemptions_total`` on its metrics registry,
which the port does not have yet; :attr:`requests` counts here.
:func:`install_sigterm_handler` is the host processes' (``serve-data``,
``coordinator``) hook: SIGTERM sets their stop flag and their own
``finally`` drains them, as Ctrl-C does.
"""

from __future__ import annotations

import signal
import threading
from typing import Callable

__all__ = ["PreemptionHandler", "install_sigterm_handler"]


def install_sigterm_handler(callback: Callable[[], None]) -> bool:
    """Run ``callback`` (idempotent and cheap, typically ``Event.set``) on
    SIGTERM. ``False`` where that cannot be installed (off the main
    thread, as a service embedded in a test is; or no SIGTERM on the
    platform): the caller keeps stopping on KeyboardInterrupt alone. A
    copy of the JAX package's function of the same name."""
    if threading.current_thread() is not threading.main_thread():
        return False
    try:
        def _handler(signum, frame):  # noqa: ARG001 — signal signature
            callback()

        signal.signal(signal.SIGTERM, _handler)
        return True
    except (ValueError, OSError, AttributeError):
        return False


class PreemptionHandler:
    """SIGTERM → ``requested`` flag.

    Usage::

        preempt = PreemptionHandler().install()
        try:
            ...  # poll preempt.requested at step boundaries
        finally:
            preempt.uninstall()

    ``install`` is a no-op off the main thread (``installed`` stays False):
    the run then has no graceful preemption path. ``request()`` triggers the
    identical drain in-process (the chaos hook, and tests that must not
    signal the pytest process).
    """

    def __init__(self):
        self._event = threading.Event()
        self._previous = None
        self.installed = False
        self.requests = 0

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self) -> None:
        """Trigger the drain without a signal (idempotent; counted once)."""
        if not self._event.is_set():
            self._event.set()
            self.requests += 1

    def install(self) -> "PreemptionHandler":
        if self.installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            return self

        def _handler(signum, frame):  # noqa: ARG001 — signal signature
            self.request()

        try:
            self._previous = signal.signal(signal.SIGTERM, _handler)
        except (ValueError, OSError):
            return self
        self.installed = True
        return self

    def uninstall(self) -> None:
        """Restore the previous SIGTERM disposition (idempotent)."""
        if not self.installed:
            return
        try:
            signal.signal(signal.SIGTERM, self._previous or signal.SIG_DFL)
        except (ValueError, OSError):
            pass
        self.installed = False
