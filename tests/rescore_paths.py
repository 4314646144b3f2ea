"""Pin the exact rescore of both packages to their native runtimes.

The JAX package's ``utils.native`` builds ``runtime/libspmv_runtime.so``
in place with ``make`` the first time it is asked for, and takes the
NumPy path of ``api.exact_rescore`` (a float64 cumsum) when that build
fails or the library it finds cannot be loaded. Test workers started
together on a checkout without the library race on that build, so a
worker may rescore through NumPy while the port rescores natively (float32
in row order): the two differ in the last bit, and the parity tests that
hold rescored values bit for bit would fail by one ulp.

``load_both_natives()`` builds the runtime with its Makefile into a
temporary target under a file lock and moves it into place atomically,
then loads it into the JAX package (resetting a failed earlier attempt of
this process) and asserts that both packages have their native library:
a failed build fails with its own reason.
"""

from __future__ import annotations

import fcntl
import os
import subprocess

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RUNTIME = os.path.join(_REPO, "runtime")
_TARGET = os.path.join(_RUNTIME, "libspmv_runtime.so")
_LOCK = os.path.join(_REPO, "build", "runtime_build.lock")

_built = False


def build_jax_runtime() -> None:
    """Build ``runtime/libspmv_runtime.so`` whole and move it into place,
    once per process, holding a lock against the other test workers."""
    global _built
    if _built:
        return
    os.makedirs(os.path.dirname(_LOCK), exist_ok=True)
    tmp = f"{_TARGET}.{os.getpid()}.tmp"
    with open(_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            res = subprocess.run(["make", "-s", "-C", _RUNTIME,
                                  f"TARGET={tmp}"],
                                 capture_output=True, text=True, timeout=300)
            if res.returncode != 0:
                raise RuntimeError(f"make -C runtime failed "
                                   f"({res.returncode}):\n{res.stdout}"
                                   f"{res.stderr}")
            os.replace(tmp, _TARGET)
            _load_jax_native()
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    _built = True


def _load_jax_native() -> None:
    from spmv_topk_tpu.utils import native as jnative

    if jnative._LIB is None:   # an earlier attempt of this process failed
        jnative._TRIED = False
    jnative._load()


def load_both_natives() -> None:
    """Make both packages' ``exact_rescore`` take its native path, or
    fail saying why not."""
    from spmv_topk_tpu.utils import native as jnative
    from spmv_topk_tpu_torch.utils import native as pnative

    build_jax_runtime()
    assert jnative.available(), "the JAX package's runtime did not load"
    assert pnative.available(), pnative.load_error
