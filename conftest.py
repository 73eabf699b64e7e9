"""pytest set-up for the whole repository.

The JAX package builds the native PNG decoder (native/libframeio.so) in
place on first use, and tests/test_native_io.py asks for it while the module
is imported.  Under pytest-xdist every worker would then build it at once,
and a worker that loaded the library while another was still writing it
skipped that file's tests.  The controller runs ``pytest_configure`` before
it starts the workers, so the library is built here, once, by the package's
own builder.
"""


def pytest_configure(config):
    from difusion_tpu.data import native_io
    native_io.native_available()
