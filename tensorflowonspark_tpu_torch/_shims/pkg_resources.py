"""Minimal ``pkg_resources`` stand-in for TensorBoard subprocesses.

setuptools >= 81 removed ``pkg_resources``, but tensorboard (<= 2.20)
still imports it for exactly two things: entry-point iteration
(``default.py`` — dynamic plugin discovery, including
tensorboard-plugin-profile) and version parsing (``data/server_ingester``).
``observability.start_tensorboard`` prepends this directory to the
subprocess PYTHONPATH only when the real module is missing; nothing in the
framework itself imports this.
"""

from packaging.version import parse as parse_version  # noqa: F401


class DistributionNotFound(Exception):
    pass


class _EntryPoint:
    def __init__(self, ep):
        self._ep = ep
        self.name = ep.name

    def load(self):
        return self._ep.load()

    resolve = load


def iter_entry_points(group, name=None):
    from importlib.metadata import entry_points

    eps = entry_points()
    try:
        selected = eps.select(group=group)       # py3.10+
    except AttributeError:  # pragma: no cover — legacy mapping API
        selected = eps.get(group, [])
    for ep in selected:
        if name is None or ep.name == name:
            yield _EntryPoint(ep)
