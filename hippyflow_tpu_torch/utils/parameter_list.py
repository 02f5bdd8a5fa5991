"""Validated parameter lists (hp.ParameterList equivalent).

The reference configures every major component through hippylib's
ParameterList — a dict of ``[default, docstring]`` pairs that rejects unknown
keys (`hippyflow/modeling/activeSubspaceProjector.py:33-66`). Same contract
here, as a thin mapping class.
"""

from __future__ import annotations


class ParameterList:
    def __init__(self, data: dict):
        """data: mapping name -> [default_value, docstring]."""
        self._data = {}
        self._doc = {}
        for k, (v, doc) in data.items():
            self._data[k] = v
            self._doc[k] = doc

    def __getitem__(self, key):
        if key not in self._data:
            raise KeyError(f"unknown parameter {key!r}")
        return self._data[key]

    def __setitem__(self, key, value):
        if key not in self._data:
            raise KeyError(f"unknown parameter {key!r}")
        self._data[key] = value

    def __contains__(self, key):
        return key in self._data

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def showMe(self):  # reference-compatible spelling
        for k in sorted(self._data):
            print(f"{k:30s} = {self._data[k]!r:20} # {self._doc[k]}")

    def __repr__(self):
        return f"ParameterList({self._data!r})"
