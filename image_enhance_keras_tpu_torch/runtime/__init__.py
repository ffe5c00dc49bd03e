"""Serving runtime (mirror of ``runtime/``): the native codec
(``native_io``), the overlapped directory pipeline (``serving``) and the
exported serving artifact (``export``).

The native codec builds at first use from ``native/iek_io.cpp``; without
``g++`` or libpng the other codecs of ``data/io.py`` serve.
"""
