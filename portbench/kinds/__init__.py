"""Kinds of loop, one module each, found by the ``kind`` a mix names."""
