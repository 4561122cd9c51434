"""Repository-wide pytest set-up: build the native host library once, in
the controlling process, before any test worker starts.

Both packages load ``build/libeal_host.so`` and build it at first use when
it is missing. Under pytest-xdist several workers would otherwise start
that build at once, and one of them could load a half-written file. The
port's ``runtime/native.py::build_host_library`` compiles under a lock into
a temporary file and renames it into place; run here, it leaves the
library complete before the workers exist, so neither package's first-use
build runs during the tests.
"""

import warnings


def pytest_configure(config):
    if hasattr(config, "workerinput"):       # an xdist worker: the controller built it
        return
    from esp_audio_libs_tpu_torch.runtime.native import build_host_library
    try:
        build_host_library()
    except Exception as e:  # noqa: BLE001 - the tests that need the library report it
        warnings.warn(f"building build/libeal_host.so failed: {e}", stacklevel=1)
