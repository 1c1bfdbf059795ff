"""Twins of ``examples/*.py`` on the port: ``python -m
repro_torch.examples.<name>``, each with ``--device`` (``cuda`` by
default, ``cpu`` to run the plain twins)."""
