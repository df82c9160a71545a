"""The JAX package's native JPEG decoder, built privately for a test module
of the port.

The JAX package builds its decoder into one path beside its source, through
one temporary file that every process links into; under ``pytest -n 6`` a
process that loses that race keeps ``_load_failed`` for its whole life and
decodes with PIL instead (and cannot extract coefficients at all). The
port's tests that read a JAX server's or a JAX graph's batches hold them
bit for bit against the port's native decode, so they must not depend on
which process won: :func:`private_jax_native` points the JAX module at a
library of the test's own (built once, into a temporary directory), resets
its load state and asserts that it loaded; the JAX module's state is
restored after. ``jax_native`` is that, once a module.
"""

import contextlib

import pytest


@contextlib.contextmanager
def private_jax_native(directory):
    """The JAX package's ``native.jpeg`` bound to a library built in
    ``directory`` (a ``pathlib.Path``), loaded, for the ``with`` block."""
    from lance_distributed_training_tpu.native import jpeg as jax_jpeg

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_jpeg, "_LIB_PATH", str(directory / "jax_ldt.so"))
        patch.setattr(jax_jpeg, "_CACHE_LIB",
                      str(directory / "jax_ldt_cache.so"))
        patch.setattr(jax_jpeg, "_lib", None)
        patch.setattr(jax_jpeg, "_load_failed", False)
        patch.delenv("LDT_DISABLE_NATIVE", raising=False)
        assert jax_jpeg.native_available(), \
            "the JAX package's native decoder did not build"
        yield jax_jpeg


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """:func:`private_jax_native` for the whole test module."""
    with private_jax_native(tmp_path_factory.mktemp("jax_native")) as lib:
        yield lib
