"""A race-free first load of the JAX package's native host library.

``tudocomp_tpu.native`` compiles ``native/tdc_native.cpp`` straight into
``native/build/tdc_native.so`` on its first call and then loads it. Under
pytest-xdist several workers make that first call at about the same time,
and a worker that loads the file while another worker's linker is still
writing it gets ``OSError: ... file too short`` and no library for the
rest of its run.

Every xdist worker collects every test module before it runs a test. So
this module, at import, takes an exclusive ``flock`` on a lock file in
``native/build/``, asks ``available()`` (which builds the library if its
stamp is stale and loads it) and releases the lock: the first worker
builds under the lock, the others wait for it during collection, and by
the time any test runs the library on disk is whole.
"""

import fcntl
import os

from tudocomp_tpu import native as jax_native

_BUILD_DIR = os.path.dirname(jax_native._SO)


def _load_under_lock() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".build.lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return jax_native.available()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


_AVAILABLE = _load_under_lock()


def test_jax_native_library_loaded():
    assert _AVAILABLE
    assert jax_native.available()
