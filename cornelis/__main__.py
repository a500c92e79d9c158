"""`python -m cornelis` -- the reference's `cornelis` binary equivalent
(src/cornelis.cpp:76-79), with real argument parsing (see cli.py)."""

import sys

from .cli import main

sys.exit(main())
