"""The port's ops: the kernels' wrappers (``q40``, ``q8``, ``attention``),
their build (``_build``) and the plain elementwise ops (``kernels``).

:data:`COUNT_LOCK` guards every launch counter of the wrappers: several
servers in one process (``serve-pod``) launch from their own scheduler
threads, ``+=`` on a module global is not atomic across threads, and a
CUDA graph capture (``runtime/graphs.py``) holds the lock from its counter
snapshot before to the one after, so that its deltas are its own.
"""

import threading

COUNT_LOCK = threading.RLock()
