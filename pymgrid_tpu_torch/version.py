__version__ = "0.2.0"

#: Version of the reference API surface this framework mirrors
#: (Total-RD/pymgrid, ``src/pymgrid/version.py:1``).
REFERENCE_API_VERSION = "1.2.2"
