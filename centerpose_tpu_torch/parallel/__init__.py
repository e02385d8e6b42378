"""Data-parallel training across processes (``mesh.py``)."""
