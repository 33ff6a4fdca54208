"""Data parallelism over processes, one card each (`mesh.py`)."""
