#!/usr/bin/env python
"""Entry point: python driver_qft.py parameters.in (cf. src/driver_qft.cc)."""
import sys

from mlmcpathintegral.drivers.qft import main
from mlmcpathintegral.utils.compile_cache import enable_compile_cache

if __name__ == "__main__":
    enable_compile_cache()
    sys.exit(main())
