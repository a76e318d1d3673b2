#!/usr/bin/env python3
"""pytest with this checkout's ``tests/`` bound to the package name
``tests``, for the ``gpu``-marked tests on a machine where another
installed distribution ships a regular package called ``tests``: that
package would shadow the checkout's namespace directory, and every
``from tests.torch_threads import ...`` would fail at collection.

    python3 tools/card_pytest.py tests/test_torch_port_kernels.py \\
        tests/test_torch_port_card_pipeline.py \\
        tests/test_torch_port_context_parallel.py -m gpu --noconftest

Arguments go to pytest unchanged.  Imports nothing of JAX.
"""

import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
tests = types.ModuleType("tests")
tests.__path__ = [os.path.join(ROOT, "tests")]
sys.modules["tests"] = tests

import pytest  # noqa: E402

if __name__ == "__main__":
    sys.exit(pytest.main(sys.argv[1:]))
