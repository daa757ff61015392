#!/bin/sh
# Build the native loader library by hand; saccot/io/native.py runs the same
# build at first use. Output: build/native/libsaccot_native.so at the
# repository root.
set -e
cd "$(dirname "$0")/.."
python -c "from saccot.io.native import build; p = build(); print('built', p); raise SystemExit(p is None)"
