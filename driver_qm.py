#!/usr/bin/env python
"""Entry point: python driver_qm.py parameters.in (cf. src/driver_qm.cc)."""
import sys

from mlmcpathintegral.drivers.qm import main
from mlmcpathintegral.utils.compile_cache import enable_compile_cache

if __name__ == "__main__":
    enable_compile_cache()
    sys.exit(main())
