"""Part of the benchmark harness (see ``perfbench/__init__.py``)."""
